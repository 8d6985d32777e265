"""The slice against the JAX package at the config as it ships
(``pack_xy=True``), scene and chains as in test_torch_slice.py.

The JAX kernel then codes the strips as 16+16-bit fixed point, which moves
projected corners by up to half a quantum, so edges may shift by a pixel
where the port (float32 strips) keeps them. The figures are printed; the bar
is PSNR >= 50 dB.
"""

from test_torch_slice import (  # noqa: F401 - fixtures
    frame_stats, jax_slice, pngs, port_frames)


def test_slice_against_the_shipped_pack_xy_config(pngs, port_frames):
    p, _ = frame_stats(port_frames, jax_slice(*pngs, pack_xy=True),
                       "slice, JAX at pack_xy=True")
    assert p >= 50.0
