"""The port's scan attributes on the big_grid variant and its wireframe mode
against the JAX kernel (Pallas interpret mode), on the CPU.

Scene: test_torch_scan_kernel.py's d7 129x129 grid at 128x96, frontal and 4
degrees yawed, ``pack_xy`` off.

* **Attributes**, at test_torch_scan_big_grid.py's preset-4 knobs (big_grid,
  rmax 48, colfix 1, hyps 1, sr 10, off 4, dmax 5, edge cull 0.25): the
  march's u, v, model z, coverage and raster z against the JAX kernel's
  ``attrs`` mode. Coverage must be equal. On the pixels both cover the
  rest agree up to rounding, as XLA contracts the winner's depth and
  attribute sums into multiply-adds and the port does not: raster z within
  4 ulps, u and v within 4e-6, and model z within 4e-3, below one level of
  the debug_z shade (the model z rebuilt from the raster z through the
  inverse MVP magnifies the raster z's ulps by the perspective).
* **Wireframe** (the standard variant at hyps 1, colfix 1): the frames
  against the JAX kernel's ``wireframe`` mode at test_torch_scan_kernel.py's
  bars (>= 60 dB, <= 0.1 % of pixels off by more than 1 LSB), and its
  coverage is a strict part of the texture mode's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from depthrenderer_tpu.ops import raster_scan as jrs

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs
from test_torch_scan_big_grid import big_grid_config
from test_torch_scan_kernel import (H, N, W, checker, frame_stats, jax_config,
                                    scene)

torch.set_num_threads(1)


def test_big_grid_attrs_match_jax():
    cfg = big_grid_config()
    verts, uvs, _, mvps = scene()
    vg = verts.reshape(N, N, 3)
    win, w0, bounds, canch, mid, _ = jrs._prep_scan_batched(
        jnp.asarray(mvps), jnp.asarray(vg), W, H, cfg)
    minv = trs.minv_rows(torch.from_numpy(mvps))
    tex = checker()
    texq = jrs._pack_texture(jnp.asarray(tex, jnp.float32), 64, 256)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jrs._raster_scan_pallas(
            win, texq, tex.shape[:2], jnp.asarray(minv), w0, bounds, canch,
            mid, W, H, N, N, cfg, "attrs", True))
    T, nb = out.shape[:2]
    want = out.transpose(0, 2, 1, 3, 4).reshape(T, 8, nb * 8, -1)

    tcfg = convert.scan_config_from_dict(dataclasses.asdict(cfg))
    g = trs.ScanGeometry.of(W, H, N, N, tcfg)
    prep = trs.prep_scan(torch.from_numpy(mvps), torch.from_numpy(vg), W, H,
                         tcfg)
    for i in range(T):
        args = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec = trs.solve_records(*args, g, tcfg)
        got = trs.march_exact(rec, *args, prep.canch[i], prep.mid[i],
                              minv[i], g, tcfg, raster_z=True).numpy()
        w = want[i, :5, :got.shape[1], :got.shape[2]]
        cov = got[3] > 0.5
        np.testing.assert_array_equal(cov, w[3] > 0.5)
        assert cov.mean() > 0.3
        ulps = np.abs(got[4][cov].view(np.int32).astype(np.int64)
                      - w[4][cov].view(np.int32).astype(np.int64)).max()
        errs = [float(np.abs(got[k][cov] - w[k][cov]).max())
                for k in range(3)]
        print(f"frame {i}: raster z within {ulps} ulps, u / v / model z "
              f"within {errs}")
        assert ulps <= 4 and max(errs[:2]) <= 4e-6 and errs[2] <= 4e-3


def test_wireframe_matches_jax():
    cfg = jax_config(hyps=1, colfix=1)
    verts, uvs, _, mvps = scene()
    tex = checker()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrs.render_frames_scan(
            mvps, verts.reshape(N, N, 3), uvs.reshape(N, N, 2),
            tex.astype(np.float32), W, H, cfg, "wireframe", interpret=True))
    tcfg = convert.scan_config_from_dict(dataclasses.asdict(cfg))
    mesh = convert.scene_from_numpy(verts, uvs, tex)
    frames = {}
    for mode in ("wireframe", "texture"):
        raw, _ = trs.render_frames_scan(
            torch.from_numpy(mvps), mesh.vertices.reshape(N, N, 3),
            mesh.texture_coordinates.reshape(N, N, 2), mesh.texture.image, W,
            H, tcfg, mode)
        frames[mode] = trs.unpack_raw_frames(raw, W, H)
    got = frames["wireframe"]
    p, off, n_diff = frame_stats(got, want)
    print(f"wireframe: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, {n_diff} differ")
    assert p >= 60.0 and off <= 0.001

    def covered(f):
        return (f[..., :3].max(-1) > 0) | (f[..., 3] != 255)

    wire, solid = covered(got), covered(frames["texture"])
    assert 0.2 < wire.mean() < solid.mean() and not (wire & ~solid).any()
