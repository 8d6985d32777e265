"""The port's scan against the JAX kernel where the JAX kernel's two-subtable
windows bind: ``cw = 384`` on a grid of more than 384 columns.

At 1080p the tiers' transposed pass marches ``cw = 384`` columns, so its
fetch window is ``CWF = 512`` columns, four 128-column subtables. There the
JAX kernel fetches records (``gather_rec``) and colfix fan columns (``NS2``)
through a window of two subtables at a per-block base, and an index outside
that window clamps to its edge; the port reads every column
(``ops/raster_scan.py``'s module docstring). This file counts the pixels
where that makes the two differ, and checks what they are.

Scene: the depth map of test_torch_scan_kernel.py meshed at density 9 with
every fourth grid row kept (a 129 x 513 grid: CL = 640), rendered at 512x96
with that file's two views, so a 128-pixel block spans about as many grid
columns as a block of the 1080p transposed pass does (~128 against ~121).
Config: the patch tier's pass-2 knobs (sr 6, off 2, dmax 4, hyps 1, colfix
1) at ``cw = 384``, ``pack_xy=False``. One interpret-mode compile.

Bars, with their reasons: the prep integers are equal. At most 0.1 % of
pixels are off by more than 1 LSB (test_torch_scan_kernel.py's share bar;
its PSNR bar is left out, as the pixels counted here are whole flips). Every
such pixel is one where the port agrees with the brute-force oracle
(``raster_reference``, within 8 LSB) and so shows the JAX kernel's window
missing the covering cell, not the port departing from the algorithm. The
oracle renders only the triangles whose projected x-extent reaches those
pixels' columns, which is all that can cover them.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu.ops import raster_reference
from depthrenderer_tpu.ops import raster_scan as jrs

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs
from test_torch_scan_kernel import checker, frame_stats, scene, scene_depth

torch.set_num_threads(1)

W, H, DENSITY, ROW_STEP = 512, 96, 9, 4


@functools.lru_cache(maxsize=None)
def wide_scene():
    """(vertex grid (129, 513, 3), uv grid (129, 513, 2), MVPs (2, 4, 4))."""
    verts, uvs, _ = (np.asarray(a) for a in jmesh.grid_mesh(scene_depth(),
                                                             DENSITY))
    n = 2**DENSITY + 1
    verts = verts.copy()
    verts[:, 2] *= 4.0
    vg = np.ascontiguousarray(verts.reshape(n, n, 3)[::ROW_STEP])
    uvg = np.ascontiguousarray(uvs.reshape(n, n, 2)[::ROW_STEP])
    return vg, uvg, scene()[3]


def jax_config():
    nc = wide_scene()[0].shape[1]
    return dataclasses.replace(jrs.suggest_scan_config(
        nc, W, H, cw=384, sr=6, off=2, dmax=4, hyps=1, colfix=1),
        pack_xy=False)


@functools.lru_cache(maxsize=None)
def run_jax(cfg):
    """(frames (2, H, W, 4) uint8, table width, prep integers) of the JAX
    kernel at ``cfg``."""
    vg, _, mvps = wide_scene()
    win, w0, bounds, canch, mid, _ = jrs._prep_scan_batched(
        jnp.asarray(mvps), jnp.asarray(vg), W, H, cfg)
    minv = np.linalg.inv(mvps.astype(np.float64))
    rows = np.concatenate([minv[:, 2], minv[:, 3]], 1).astype(np.float32)
    tex = checker()
    texq = jrs._pack_texture(jnp.asarray(tex, jnp.float32),
                             max(48, cfg.tex_rows), max(128, cfg.tex_cols))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jrs._raster_scan_pallas(
            win, texq, tex.shape[:2], jnp.asarray(rows), w0, bounds, canch,
            mid, W, H, vg.shape[0], vg.shape[1], cfg, "texture", True))
    ints = [np.asarray(a) for a in (w0, bounds, canch, mid)]
    return jrs.unpack_raw_frames(out, W, H), win.shape[3], ints


def run_port(jax_cfg):
    vg, _, mvps = wide_scene()
    cfg = convert.scan_config_from_dict(dataclasses.asdict(jax_cfg))
    n_r, n_c = vg.shape[:2]
    g = trs.ScanGeometry.of(W, H, n_r, n_c, cfg)
    prep = trs.prep_scan(torch.from_numpy(mvps), torch.from_numpy(vg), W, H,
                         cfg)
    minv = trs.minv_rows(torch.from_numpy(mvps))
    texq = trs.pack_texture(torch.from_numpy(checker()))
    frames = []
    for i in range(len(mvps)):
        args = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec = trs.solve_records(*args, g, cfg)
        attrs = trs.march_exact(rec, *args, prep.canch[i], prep.mid[i],
                                minv[i], g, cfg)
        frames.append(trs.shade(attrs, texq, g, cfg, "texture"))
    ints = [a.numpy() for a in (prep.w0, prep.bounds, prep.canch, prep.mid)]
    return trs.unpack_raw_frames(torch.stack(frames), W, H), ints


def oracle_columns(k, cols, edge_cull_threshold=None):
    """The oracle's frame k, exact in the pixel columns ``cols``: only the
    triangles whose projected x-extent reaches them are drawn."""
    vg, uvg, mvps = wide_scene()
    n_r, n_c = vg.shape[:2]
    i, j = np.meshgrid(np.arange(n_r - 1), np.arange(n_c - 1), indexing="ij")
    a = i * n_c + j
    b = a + n_c
    tris = np.stack([a, b, a + 1, a + 1, b, b + 1], -1).reshape(-1, 3)
    verts = vg.reshape(-1, 3)
    sx = raster_reference._project(verts, mvps[k], W, H)[0][tris]
    lo, hi = sx.min(axis=1), sx.max(axis=1)
    keep = np.zeros(len(tris), bool)
    for c in cols:
        keep |= (lo <= c + 1.0) & (hi >= c)
    return raster_reference.rasterize_reference(
        verts, uvg.reshape(-1, 2), tris[keep].reshape(-1), mvps[k], checker(),
        W, H, edge_cull_threshold=edge_cull_threshold)


def windows_against_jax(cfg, label):
    """Frames of the port and of the JAX kernel at ``cfg`` on the wide
    scene, held to this file's bars -> (pixels > 1 LSB apart, those where
    the oracle agrees with the port, those where it agrees with JAX)."""
    want, cl, want_ints = run_jax(cfg)
    got, got_ints = run_port(cfg)
    assert min(cfg.cw + 128, cl) // 128 >= 4   # the two-subtable regime
    for name, a, b in zip(("w0", "bounds", "canch", "mid"), got_ints,
                          want_ints):
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=name)
    p, off, n_diff = frame_stats(got, want)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    print(f"{label}: PSNR {p:.2f} dB, {int((diff > 1).sum())} of "
          f"{diff.size} pixels > 1 LSB ({off:.5%}), {n_diff} differ")
    assert got.shape == want.shape == (2, H, W, 4)
    assert (got[..., :3].max(axis=-1) > 0).mean() > 0.5
    assert off <= 0.001
    port_right = jax_right = 0
    for k in range(len(got)):
        ys, xs = np.nonzero(diff[k] > 1)
        if len(xs) == 0:
            continue
        ref = oracle_columns(k, np.unique(xs),
                             cfg.edge_cull_threshold).astype(np.int32)
        port_err = np.abs(got[k].astype(np.int32) - ref).max(-1)[ys, xs]
        jax_err = np.abs(want[k].astype(np.int32) - ref).max(-1)[ys, xs]
        port_right += int((port_err <= 8).sum())
        jax_right += int((jax_err <= 8).sum())
        assert (port_err <= 8).all(), list(zip(ys[port_err > 8],
                                               xs[port_err > 8]))
    print(f"of the pixels > 1 LSB apart, the oracle agrees with the port at "
          f"{port_right} and with JAX at {jax_right}")
    return int((diff > 1).sum()), port_right, jax_right


def test_cw384_windows_counted_against_jax():
    cfg = jax_config()
    mid = run_jax(cfg)[2][3]
    assert (mid >= 0).any() and (mid == -1).any()   # narrow and wide
    _, port_right, _ = windows_against_jax(cfg, "cw=384")
    assert port_right > 0   # the windows bind on this scene
