"""The port's scan passes (plain PyTorch on the CPU) against the JAX kernel.

One scene for every config: a 48x64 sinusoid depth map with a raised step and
a noisy patch, meshed at density 7 (a 129x129 grid, cw = 256 so both the
narrow and the wide march run), rendered at 128x96 from the frontal view and
a 4 degree yaw at 15 units, textured with the 64x48 checker. The JAX side runs
``_raster_scan_pallas`` in Pallas interpret mode with ``debug_records`` (slot
0's record planes come with the frames from the same compile), at
``pack_xy=False``, the coding the port stores.

Bars, with their reasons:

* records: ``basew`` and the strip rows are copies and must be exact;
  ``sxc``/``zc`` are interpolated by both sides with one fused multiply-add,
  allowed one ulp.
* frames: PSNR >= 60 dB and at most 0.1% of pixels off by more than 1 LSB.
  XLA's CPU backend contracts some of the exact tests' multiply-adds that
  the port keeps separate (as its CUDA kernel does), which can move a pixel
  centre that lies on an edge to the neighbouring triangle.
* oracle: the port's share of flipped pixels (a channel off by more than 8)
  against ``raster_reference`` is at most JAX's plus 0.1 percentage points.

The texture window and the colfix two-subtable fan window that the port drops
cannot bind on this scene (the 64x48 texture lies inside one 64x256 window;
the 256-column fetch window is two subtables), so these comparisons isolate
the algorithm. The four (hyps, colfix) configs are split over this file
(hyps 1, colfix 1, the one the oracle test reuses),
test_torch_scan_kernel_nocolfix.py and test_torch_scan_kernel_hyps2.py, one
or two interpret-mode compiles each.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu.ops import raster_reference
from depthrenderer_tpu.ops import raster_scan as jrs
from depthrenderer_tpu.transforms import Axis
from depthrenderer_tpu.utils import psnr

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs

# One intra-op thread: the suite's worker processes share the cores, and a
# pool of one thread per core in each of them stalls on these small tensors.
torch.set_num_threads(1)

W, H, DENSITY = 128, 96, 7
N = 2**DENSITY + 1


def scene_depth(h=48, w=64, seed=0):
    """Sinusoid relief with a raised step and a noisy (fold-heavy) patch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 127 + 100 * np.sin(xx / w * 6 + seed) * np.cos(yy / h * 4)
    d[h // 3:h // 2, w // 4:w // 2] = 250
    d[h // 2:h // 2 + 6, w // 2:w // 2 + 8] = rng.integers(0, 256, (6, 8))
    return np.clip(d, 0, 255).astype(np.uint8)


def checker(h=48, w=64):
    """tests/conftest.py's checker texture (also needed outside fixtures)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx * 255 // (w - 1)), (yy * 255 // (h - 1)),
                     ((xx // 8 + yy // 8) % 2) * 255,
                     np.full((h, w), 255)], axis=-1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def scene():
    verts, uvs, idx = (np.asarray(a) for a in jmesh.grid_mesh(scene_depth(),
                                                                DENSITY))
    verts = verts.copy()
    verts[:, 2] *= 4.0
    # At this distance the frontal view marches wide (the block's candidate
    # columns span the whole grid) and the yawed one narrow.
    base = (np.asarray(jt.perspective(18.0, W / H))
            @ np.asarray(jt.translation(dz=-15.0)))
    yaw = np.asarray(jt.rotation(np.deg2rad(4.0), axis=Axis.Y))
    mvps = np.stack([base, base @ yaw]).astype(np.float32)
    return verts, uvs, idx, mvps


def jax_config(**over):
    return dataclasses.replace(jrs.suggest_scan_config(N, W, H, **over),
                               pack_xy=False)


@functools.lru_cache(maxsize=None)
def run_jax(cfg, phases="all"):
    """(frames (T, H, W, 4) uint8, slot-0 records (T, nbands, nrec, 8, CL))
    from the JAX kernel in interpret mode. ``phases="solve"`` runs only its
    solve (a much smaller compile; the frames are then blank)."""
    verts, _, _, mvps = scene()
    vg = verts.reshape(N, N, 3)
    win, w0, bounds, canch, mid, _ = jrs._prep_scan_batched(
        jnp.asarray(mvps), jnp.asarray(vg), W, H, cfg)
    minv = np.linalg.inv(mvps.astype(np.float64))
    rows = np.concatenate([minv[:, 2], minv[:, 3]], 1).astype(np.float32)
    tex = checker()
    texq = jrs._pack_texture(jnp.asarray(tex, jnp.float32),
                             max(48, cfg.tex_rows), max(128, cfg.tex_cols))
    with pltpu.force_tpu_interpret_mode():
        out, dbg = jrs._raster_scan_pallas(
            win, texq, tex.shape[:2], jnp.asarray(rows), w0, bounds, canch,
            mid, W, H, N, N, cfg, "texture", True, debug_records=True,
            phases=phases)
        out = np.asarray(out)
        dbg = np.asarray(dbg)
    return jrs.unpack_raw_frames(out, W, H), dbg[:, :, 0]


@functools.lru_cache(maxsize=None)
def run_port(jax_cfg):
    """(frames, records (T, nbands, nbr, nrec, 8, CL), prep) from the plain
    passes on the CPU, at the port's copy of ``jax_cfg``."""
    verts, uvs, _, mvps = scene()
    cfg = convert.scan_config_from_dict(dataclasses.asdict(jax_cfg))
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    vg = mesh.vertices.reshape(N, N, 3)
    g = trs.ScanGeometry.of(W, H, N, N, cfg)
    prep = trs.prep_scan(torch.from_numpy(mvps), vg, W, H, cfg)
    minv = trs.minv_rows(torch.from_numpy(mvps))
    texq = trs.pack_texture(mesh.texture.image)
    frames, recs = [], []
    for i in range(len(mvps)):
        rec = trs.solve_records(prep.win[i], prep.w0[i], prep.bounds[i], g,
                                cfg)
        attrs = trs.march_exact(rec, prep.win[i], prep.w0[i], prep.bounds[i],
                                prep.canch[i], prep.mid[i], minv[i], g, cfg)
        frames.append(trs.shade(attrs, texq, g, cfg, "texture"))
        recs.append(rec)
    frames = trs.unpack_raw_frames(torch.stack(frames), W, H)
    return frames, torch.stack(recs).numpy(), prep


def frame_stats(got, want):
    """PSNR over all channels and the share of pixels off by > 1 LSB."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    return psnr(got, want), float((diff > 1).mean()), int((diff > 0).sum())


def check_records(recs, dbg):
    """Slot-0 records: copies exact, interpolated values within one ulp."""
    r0 = recs[:, :, 0]
    assert r0.shape == dbg.shape
    np.testing.assert_array_equal(r0[:, :, 2], dbg[:, :, 2])   # basew
    np.testing.assert_array_equal(r0[:, :, 3:], dbg[:, :, 3:])  # strips
    ulps = np.abs(r0[:, :, :2].view(np.int32).astype(np.int64)
                  - dbg[:, :, :2].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def check_against_jax(cfg):
    want, dbg = run_jax(cfg)
    got, recs, prep = run_port(cfg)
    assert got.shape == want.shape == (2, H, W, 4)
    check_records(recs, dbg)
    p, off, n_diff = frame_stats(got, want)
    print(f"hyps={cfg.hyps} colfix={cfg.colfix}: PSNR {p:.2f} dB, "
          f"{off:.5%} > 1 LSB, {n_diff} pixels differ")
    assert p >= 60.0 and off <= 0.001
    # Both marches and real coverage are exercised.
    mid = prep.mid.numpy()
    assert (mid >= 0).any() and (mid == -1).any()
    assert (got[..., :3].max(axis=-1) > 0).mean() > 0.5
    return got, want


def test_frames_and_records_match_jax_hyps1_colfix1():
    check_against_jax(jax_config(hyps=1, colfix=1))


def test_oracle_flips_no_worse_than_jax():
    cfg = jax_config(hyps=1, colfix=1)
    want, _ = run_jax(cfg)
    got, _, _ = run_port(cfg)
    verts, uvs, idx, mvps = scene()
    ref = raster_reference.rasterize_reference(verts, uvs, idx, mvps[1],
                                               checker(), W, H)

    def flips(img):
        return float((np.abs(img.astype(int) - ref.astype(int)).max(-1)
                      > 8).mean())

    f_port, f_jax = flips(got[1]), flips(want[1])
    print(f"oracle flips: port {f_port:.4%}, JAX {f_jax:.4%}")
    assert f_port <= f_jax + 0.001
