"""The port's big_grid scan variant with in-kernel edge culling (plain
PyTorch on the CPU) against the JAX kernel in Pallas interpret mode.

BASELINE preset 4 (4K at mesh density 12, edge cull 0.25) runs the big_grid
variant with sr 10, off 4, dmax 5, hyps 1 and colfix 1. Those knobs are
forced here at small scale, in one ``ScanConfig``, on
test_torch_scan_kernel.py's scene (the d7 129x129 grid at 128x96, frontal
and 4 degrees yawed), with ``rmax = 48`` so that the 128-column chunks get
row windows at different origins, and ``pack_xy`` off. The 256-column fetch
window is two subtables, so the march sweeps it densely;
test_torch_scan_big_grid_clamps.py covers the chunked march of wider
windows.

Bars, with their reasons: the prep integers (the per-chunk window origins
packed in ``bounds``) are equal; slot 0's records as
test_torch_scan_kernel.py bars them (copies exact, the interpolated crossing
within one ulp), their bracket rows global; frames at that file's bars
(>= 60 dB, <= 0.1 % of pixels off by more than 1 LSB); the cull removes
coverage.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from depthrenderer_tpu.ops import raster_scan as jrs

from test_torch_scan_kernel import (H, N, W, check_records, frame_stats,
                                    run_jax, run_port, scene)

torch.set_num_threads(1)

PRESET4 = dict(big_grid=True, rmax=48, colfix=1, hyps=1, sr=10, off=4,
               dmax=5, edge_cull_threshold=0.25)


def big_grid_config(**over):
    return dataclasses.replace(
        jrs.suggest_scan_config(N, W, H, **dict(PRESET4, **over)),
        pack_xy=False)


def test_big_grid_edge_cull_matches_jax():
    cfg = big_grid_config()
    assert cfg.big_grid and cfg.edge_cull_threshold == 0.25
    verts, _, _, mvps = scene()
    want_ints = jrs._prep_scan_batched(jnp.asarray(mvps),
                                       jnp.asarray(verts.reshape(N, N, 3)),
                                       W, H, cfg)
    want, dbg = run_jax(cfg)
    got, recs, prep = run_port(cfg)
    for name, a, b in zip(prep._fields, prep, want_ints):
        np.testing.assert_array_equal(a.numpy().astype(np.float64),
                                      np.asarray(b).astype(np.float64),
                                      err_msg=name)
    bounds = prep.bounds.numpy().astype(np.int64)
    assert len(np.unique(bounds & 0x3FF)) > 2   # chunk windows differ
    assert (prep.w0.numpy() == 0).all() and (prep.mid.numpy() == -1).all()
    check_records(recs, dbg)
    basew = recs[:, :, 0, 2]
    assert (basew[basew > -1.0e8] >= 48).any()  # global rows past rmax
    p, off, n_diff = frame_stats(got, want)
    print(f"big_grid + edge cull: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, "
          f"{n_diff} pixels differ")
    assert p >= 60.0 and off <= 0.001
    solid, _, _ = run_port(big_grid_config(edge_cull_threshold=None))
    covered = (got[..., :3].max(-1) > 0).mean()
    assert 0.5 < covered < (solid[..., :3].max(-1) > 0).mean()
