"""The port's big_grid scan against the JAX kernel where the JAX kernel's
windows bind: a fetch window of five 128-column chunks and an ``rmax``-row
colfix fan window.

At d11 and d12 the big_grid fetch window is 640 and 1024 columns. There the
JAX kernel marches chunk by chunk behind a block gate (the port follows it),
fetches records through two 128-column subtables at a per-block base and
reads the colfix fan through two subtables and one ``rmax``-row window at a
shared origin, where an index outside a window clamps to its edge (and a fan
row past the row window is not tested). The port reads every column and row
(``ops/raster_scan.py``'s module docstring). This file counts the pixels
where that makes the two differ, and checks what they are.

Scene and method: test_torch_scan_cw384.py's (the 129 x 513 grid at 512x96,
two views; only the triangles that reach a pixel's column are drawn by the
oracle). Config: ``big_grid`` at ``cw = 512`` (fetch window 640 = 5 chunks,
as at d11), ``rmax = 48`` (chunk windows at different origins, so the fan's
union of rows can pass its ``rmax``-row window), and preset 4's other knobs
(sr 10, off 4, dmax 5, hyps 1, colfix 1, edge cull 0.25). One
interpret-mode compile.

Bars: the prep integers are equal; at most 0.1 % of pixels are off by more
than 1 LSB; at every such pixel the port agrees with the oracle (within 8
LSB, with the same edge cull), and at some of them JAX does not.
"""

import dataclasses

from depthrenderer_tpu.ops import raster_scan as jrs

from test_torch_scan_cw384 import H, W, wide_scene, windows_against_jax


def test_big_grid_windows_counted_against_jax():
    nc = wide_scene()[0].shape[1]
    cfg = dataclasses.replace(jrs.suggest_scan_config(
        nc, W, H, big_grid=True, cw=512, rmax=48, colfix=1, hyps=1, sr=10,
        off=4, dmax=5, edge_cull_threshold=0.25), pack_xy=False)
    assert min(cfg.cw + 128, -(-nc // 128) * 128) // 128 == 5
    n_off, port_right, jax_right = windows_against_jax(cfg, "big_grid")
    assert n_off <= 0.001 * 2 * W * H and port_right == n_off
    assert port_right > jax_right
