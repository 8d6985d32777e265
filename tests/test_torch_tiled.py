"""The port's tiled rasteriser against the JAX package's, on the CPU.

Scenes as ``tests/test_pallas.py`` uses them: ``test_raster.scene`` at
density 3-4, tiles of 8x32 pixels, 16x16-cell windows, 128-triangle chunks,
64x48 to 96x72 frames. The same numpy arrays go into both packages; the JAX
Pallas kernel runs in interpret mode. Bars, with their reasons:

* Binning: ``suggest_config``, ``measured_config``, tile bounds, windows,
  overflow counts and active chunk ranges are integers and must be equal.
* Planes from the same projected grid: within 4 ulp (the port rounds each
  expression as XLA's CPU backend contracts it, so they are equal in
  practice).
* ``raster_pairs_plain`` on the JAX package's own planes against
  ``raster_pairs_pallas``: coverage equal on >= 99.99 % of pixels, u, v and
  z_model within 1e-5 relative where both cover.
* Frames: PSNR >= 60 dB with <= 0.2 % of pixels off by more than 1 LSB,
  the JAX tests' own cross-route bar (``test_pallas.py:37``); wireframe
  >= 30 dB with <= 3 % (``test_pallas.py:151``). Inside one jit XLA fuses the
  projection into the plane setup and contracts there too, so whole frames
  differ from the port's in the last bits of a few planes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu.ops import common as jcommon
from depthrenderer_tpu.ops import raster_grid as jrg
from depthrenderer_tpu.ops import raster_pallas as jrp
from depthrenderer_tpu.transforms import Axis
from depthrenderer_tpu.utils import psnr

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import common as tcommon
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_pallas as trp
from depthrenderer_tpu_torch.ops import tiled as ttl

from test_raster import scene

torch.set_num_threads(1)

CFG = jcommon.RasterConfig(tile_h=8, tile_w=32, window_rows=16,
                           window_cols=16, patch_size=8, map_batch=8,
                           chunk_tris=128)
W, H = 96, 72


def T(a):
    return torch.from_numpy(np.array(a))


def tcfg(cfg):
    return convert.raster_config_from_jax(dataclasses.asdict(cfg))


def scene_arrays(density=4, size=(48, 64), seed=1, yaw_deg=0.0):
    verts, uvs, _, mvp, _ = scene(density=density, size=size, seed=seed)
    mvp = (mvp @ np.asarray(jt.rotation(np.deg2rad(yaw_deg), axis=Axis.Y))
           ).astype(np.float32)
    n = 2**density + 1
    return (verts.reshape(n, n, 3).astype(np.float32),
            uvs.reshape(n, n, 2).astype(np.float32), mvp)


def dual_anchor_scene():
    """Blocky depth (strong discontinuities): row spans exceed one window."""
    rng = np.random.default_rng(9)
    depth = np.kron(rng.integers(0, 256, size=(4, 4), dtype=np.uint8),
                    np.ones((12, 16), np.uint8))
    verts, uvs, _ = [np.asarray(a) for a in jmesh.grid_mesh(depth, 4)]
    verts = verts.copy()
    verts[:, 2] *= 4.0
    mvp = (np.asarray(jt.perspective(18.0, W / H))
           @ np.asarray(jt.translation(dz=-10.0))).astype(np.float32)
    return (verts.reshape(17, 17, 3).astype(np.float32),
            uvs.reshape(17, 17, 2).astype(np.float32), mvp)


def frame_bar(got, want, min_psnr=60.0, max_off=0.002):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    p, off = psnr(got, want), float((diff > 1).mean())
    assert got.shape == want.shape
    assert p >= min_psnr and off <= max_off, (p, off)


def padded_xy(vg, mvp, cfg):
    """The port's padded projected grid, and its sx/sy as numpy."""
    g = trg._padded_grid(T(mvp), T(vg), T(np.zeros(vg.shape[:2] + (2,),
                                                    np.float32)),
                         W, H, tcfg(cfg))
    return g, g[0].numpy(), g[1].numpy()


@pytest.fixture(scope="module")
def texture(checker_texture):
    return checker_texture.astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and binning integers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantile,anchors,scene_kind", [
    (0.995, 1, "sine"), (1.0, 1, "sine"), (0.995, 2, "blocks"),
    (1.0, 2, "blocks")])
def test_configs_equal_jax(quantile, anchors, scene_kind):
    if scene_kind == "sine":
        vg, _, mvp = scene_arrays(yaw_deg=5.0)
    else:
        vg, _, mvp = dual_anchor_scene()
    mvps = np.stack([mvp, mvp @ np.asarray(
        jt.rotation(np.deg2rad(3.0), axis=Axis.X), np.float32)])
    want = jrg.measured_config(mvps, vg, W, H, quantile=quantile,
                               row_anchors=anchors, tile_h=8, tile_w=32)
    got = trg.measured_config(T(mvps), T(vg), W, H, quantile=quantile,
                              row_anchors=anchors, tile_h=8, tile_w=32)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for n, w, h, kw in [(17, 96, 72, {}), (1025, 1920, 1080, {}),
                        (257, 320, 240, dict(tile_w=32, chunk_tris=128))]:
        assert dataclasses.asdict(tcommon.suggest_config(n, w, h, **kw)) == \
            dataclasses.asdict(jcommon.suggest_config(n, w, h, **kw))


@pytest.mark.parametrize("anchors", [1, 2])
def test_tile_bounds_windows_and_overflow_equal_jax(anchors):
    vg, uvg, mvp = dual_anchor_scene()
    cfg = dataclasses.replace(CFG, window_rows=8, row_anchors=anchors)
    _, sx, sy = padded_xy(vg, mvp, cfg)
    ntr, ntc = -(-H // 8), -(-W // 32)
    want = jrg._tile_bounds(jnp.asarray(sx), jnp.asarray(sy), cfg, W, H, ntr,
                            ntc)
    got = trg._tile_bounds(T(sx), T(sy), tcfg(cfg), W, H, ntr, ntc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jrg._tile_windows(jnp.asarray(sx), jnp.asarray(sy), cfg, W, H,
                             ntr, ntc)
    got = trg._tile_windows(T(sx), T(sy), tcfg(cfg), W, H, ntr, ntc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if anchors == 1:   # one narrow window overflows; two cover the spans
        assert int(got[2].sum()) > 0
    mvps = np.stack([mvp, mvp @ np.asarray(
        jt.rotation(np.deg2rad(4.0), axis=Axis.Y), np.float32)])
    np.testing.assert_array_equal(
        trg.binning_overflow_tiles(T(mvps), T(vg), T(uvg), W, H,
                                   tcfg(cfg)).numpy(),
        np.asarray(jrg.binning_overflow_tiles(mvps, vg, uvg, W, H, cfg)))


def test_projection_equals_jax_under_jit():
    vg, uvg, mvp = scene_arrays(yaw_deg=5.0)
    want = jax.jit(jcommon.project_vertices, static_argnums=(2, 3))(
        vg, mvp, W, H)
    got = tcommon.project_vertices_tiled(T(vg), T(mvp), W, H)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Prep planes and the pair kernel's plain twin
# ---------------------------------------------------------------------------

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("edge_cull", [None, 1.5])
def test_prep_tile_planes_equal_jax(edge_cull):
    vg, uvg, mvp = scene_arrays(yaw_deg=5.0)
    cfg = dataclasses.replace(CFG, edge_cull_threshold=edge_cull)
    g = trg._padded_grid(T(mvp), T(vg), T(uvg), W, H, tcfg(cfg))
    wr = np.array([0, 0, 0], np.int32)
    wc = np.array([0, 0, 0], np.int32)
    px0 = np.array([0, 32, 64], np.int32)
    py0 = np.array([0, 24, 64], np.int32)
    floors = np.array([0, 3, 12], np.int32)
    # The grid is an argument of the jit, not a constant XLA could fold.
    want = jax.jit(jax.vmap(
        lambda v, r, c, x, y, f: jrp._prep_tile_planes(
            v, r, c, x, y, f, H, cfg), in_axes=(None, 0, 0, 0, 0, 0)))(
        g.numpy(), wr, wc, px0, py0, floors)
    got = trp._prep_tile_planes(g, T(wr), T(wc), T(px0), T(py0), T(floors),
                                H, tcfg(cfg))
    for a, b in zip(got[:2], want[:2]):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert _ulps(a, b).max() <= 4
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("anchors", [1, 2])
def test_prep_stage_integers_equal_jax(anchors):
    vg, uvg, mvp = dual_anchor_scene()
    cfg = dataclasses.replace(CFG, window_rows=8, row_anchors=anchors)
    want = [np.asarray(a) for a in jrp._prep_stage(mvp, vg, uvg, W, H, cfg)]
    got = [a.numpy() for a in trp._prep_stage_impl(T(mvp), T(vg), T(uvg), W,
                                                   H, tcfg(cfg))]
    for a, b in zip(got, want):
        assert a.shape == b.shape
    for a, b in zip(got[2:], want[2:]):   # px0, py0, jlo, jhi
        np.testing.assert_array_equal(a, b)
    # Pass B's floors: the JAX chunk ranges from the port's floors.
    g = trg._padded_grid(T(mvp), T(vg), T(uvg), W, H, tcfg(cfg))
    wr, wc, px0, py0, floors = trp._tile_passes(g, tcfg(cfg), W, H)
    jlo, jhi = jax.jit(jax.vmap(
        lambda v, r, c, x, y, f: jrp._prep_tile_planes(
            v, r, c, x, y, f, H, cfg)[2:], in_axes=(None, 0, 0, 0, 0, 0)))(
        g.numpy(), wr.numpy(), wc.numpy(), px0.numpy(), py0.numpy(),
        floors.numpy())
    np.testing.assert_array_equal(np.asarray(jlo), want[4])
    np.testing.assert_array_equal(np.asarray(jhi), want[5])


@pytest.mark.parametrize("yaw_deg,anchors", [(0.0, 1), (5.0, 1), (5.0, 2)])
def test_pairs_plain_matches_pallas_kernel(yaw_deg, anchors):
    vg, uvg, mvp = scene_arrays(yaw_deg=yaw_deg)
    cfg = dataclasses.replace(CFG, row_anchors=anchors)
    planes = [np.asarray(a) for a in jrp._prep_stage(mvp, vg, uvg, W, H, cfg)]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrp.raster_pairs_pallas(*planes, H, cfg))
    got = ttl.raster_pairs_plain(*[T(a) for a in planes], H,
                                 tcfg(cfg)).numpy()
    assert got.shape == want.shape
    cov_g, cov_w = got[..., 3] > 0.5, want[..., 3] > 0.5
    assert (cov_g == cov_w).mean() >= 0.9999
    assert cov_g.mean() > 0.3
    both = cov_g & cov_w
    for k in (0, 1, 2):
        np.testing.assert_allclose(got[..., k][both], want[..., k][both],
                                   rtol=1e-5, atol=0)
    # In practice the rows are equal: the twin contracts as XLA does.
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _frames(vg, uvg, mvp, texture, cfg, mode, w=W, h=H):
    with pltpu.force_tpu_interpret_mode():
        jp = np.asarray(jrp.render_frame_pallas(mvp, vg, uvg, texture, w, h,
                                                cfg, mode))
    jg = np.asarray(jrg.render_frame_grid(mvp, vg, uvg, texture, w, h, cfg,
                                          mode))
    args = (T(mvp), T(vg), T(uvg), T(texture), w, h, tcfg(cfg), mode)
    return (jp, trp.render_frame_pallas(*args).numpy(),
            jg, trg.render_frame_grid(*args).numpy())


# Texture frontal and yawed; debug_z and the edge cull on the yawed view.
@pytest.mark.parametrize("mode,edge_cull,yaw_deg", [
    ("texture", None, 0.0), ("texture", None, 5.0), ("debug_z", None, 5.0),
    ("texture", 1.5, 5.0)])
def test_frames_match_jax(texture, yaw_deg, mode, edge_cull):
    vg, uvg, mvp = scene_arrays(yaw_deg=yaw_deg)
    cfg = dataclasses.replace(CFG, edge_cull_threshold=edge_cull)
    jp, tp, jg, tg = _frames(vg, uvg, mvp, texture, cfg, mode)
    frame_bar(tp, jp)
    frame_bar(tg, jg)
    covered = (tp[..., :3].max(-1) > 0).mean()
    assert covered > (0.05 if edge_cull else 0.5)
    if mode == "debug_z":
        assert (tp[..., 0] == tp[..., 1]).all()


@pytest.mark.parametrize("yaw_deg", [0.0, 5.0])
def test_wireframe_matches_jax(texture, yaw_deg):
    vg, uvg, mvp = scene_arrays(yaw_deg=yaw_deg)
    jp, tp, jg, tg = _frames(vg, uvg, mvp, texture, CFG, "wireframe")
    frame_bar(tp, jp, 30.0, 0.03)
    frame_bar(tg, jg, 30.0, 0.03)
    lit = (tp[..., :3].max(-1) > 0).mean()
    assert 0.1 < lit < 0.95


def test_dual_anchor_scene_matches_jax(texture):
    vg, uvg, mvp = dual_anchor_scene()
    cfg = jrg.measured_config(mvp[None], vg, W, H, quantile=1.0,
                              row_anchors=2, tile_h=8, tile_w=32)
    single = jrg.measured_config(mvp[None], vg, W, H, quantile=1.0,
                                 row_anchors=1, tile_h=8, tile_w=32)
    assert cfg.window_rows <= single.window_rows
    assert tcfg(cfg) == trg.measured_config(T(mvp[None]), T(vg), W, H,
                                            quantile=1.0, row_anchors=2,
                                            tile_h=8, tile_w=32)
    # Narrow windows, two anchors: both passes of the Pallas route do work,
    # and the grid route merges its anchors in the kernel.
    narrow = dataclasses.replace(CFG, window_rows=8, row_anchors=2)
    jp, tp, jg, tg = _frames(vg, uvg, mvp, texture, narrow, "texture")
    frame_bar(tp, jp)
    frame_bar(tg, jg)


def test_frame_grouping_with_padding(texture):
    vg, uvg, mvp = scene_arrays(density=3, size=(24, 32), seed=5)
    mvps = np.stack([mvp @ np.asarray(jt.rotation(np.deg2rad(a), axis=Axis.Y))
                     for a in (-2.0, 0.0, 2.0)]).astype(np.float32)
    cfg = tcfg(CFG)
    grouped = trp.render_frames_pallas(T(mvps), T(vg), T(uvg), T(texture), 64,
                                       48, cfg, frame_batch=2).numpy()
    single = np.stack([trp.render_frame_pallas(T(m), T(vg), T(uvg),
                                               T(texture), 64, 48,
                                               cfg).numpy() for m in mvps])
    np.testing.assert_array_equal(grouped, single)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrp.render_frames_pallas(
            mvps, vg, uvg, texture, 64, 48, CFG, frame_batch=2))
    for k in range(3):
        frame_bar(grouped[k], want[k])
    # The grid route's frames are held against JAX in the frame tests; here
    # its grouping is held against its own single frames.
    grid = trg.render_frames_grid(T(mvps), T(vg), T(uvg), T(texture), 64, 48,
                                  cfg, frame_batch=2).numpy()
    np.testing.assert_array_equal(grid, np.stack([
        trg.render_frame_grid(T(m), T(vg), T(uvg), T(texture), 64, 48,
                              cfg).numpy() for m in mvps]))
    assert not np.array_equal(grouped[0], grouped[2])


def test_grid_exact_matches_jax_at_straddling_poses(texture):
    vg, uvg, mvp = dual_anchor_scene()
    # A camera inside the scene's depth range: triangles straddle the camera
    # plane, and the control composes them from the exactly clipped soup.
    inside = (np.asarray(jt.perspective(60.0, W / H))
              @ np.asarray(jt.translation(dz=-1.0))).astype(np.float32)
    assert trg.straddling_triangles(inside, T(vg)) > 0
    for pose in (mvp, inside):
        for strips in (1, 3):
            want = np.asarray(jrg.render_frame_grid_exact(
                pose, vg, uvg, texture, W, H, strips=strips))
            got, stats = trg.render_frame_grid_exact(
                T(pose), T(vg), T(uvg), T(texture), W, H, strips=strips,
                with_stats=True)
            frame_bar(got, want)
            assert stats["strips"] == strips
            assert (stats["straddlers"] > 0) == (pose is inside)


def test_pair_wrapper_uses_the_twin_only_on_the_cpu():
    vg, uvg, mvp = scene_arrays(density=3, size=(24, 32), seed=2)
    cfg = tcfg(CFG)
    tables = trp._prep_stage_batched(T(mvp)[None], T(vg), T(uvg), 64, 48,
                                     cfg)
    planes = trp._prep_stage_impl(T(mvp), T(vg), T(uvg), 64, 48, cfg)
    ttl.reset_launch_counts()
    np.testing.assert_array_equal(
        ttl.raster_pairs(*tables, 48, cfg).numpy(),
        ttl.raster_pairs_plain(*planes, 48, cfg).numpy())
    assert ttl.LAUNCHES == {"pairs": 0}
    assert ttl.active_pairs(planes[4], planes[5], 64, 256) > 0
    with pytest.raises(AssertionError, match="row anchors"):
        trp.render_frame_pallas(T(mvp), T(vg), T(uvg), T(np.zeros((4, 4, 4))),
                                64, 48, dataclasses.replace(cfg,
                                                            row_anchors=3))


# ---------------------------------------------------------------------------
# The slice end to end: PNG pair -> CLI -> AVI, against the JAX package
# ---------------------------------------------------------------------------

CLI_ARGS = ["--frames", "2", "--codec", "DIB ", "--device", "cpu"]
CLI_SIZE = (96, 72, 4)   # width, height, mesh density


def _jax_clip(cp, dp, impl):
    """The JAX package's chain on the same PNG pair -> (2, 72, 96, 4)."""
    import depthrenderer_tpu as jdr
    from depthrenderer_tpu import animation as janim
    from depthrenderer_tpu import io as jio
    from depthrenderer_tpu.render import render_clip

    colour = jio.load_colour(cp)
    depth = jio.resize(jio.load_depth(dp), colour.shape)
    w, h, density = CLI_SIZE
    mesh = jdr.Mesh.from_texture(jdr.Texture(colour), depth_map=depth,
                                 density=density)
    mesh.vertices[:, 2] *= 4.0
    camera = jdr.Camera(window_size=(colour.shape[1], colour.shape[0]),
                        fov_y=18.0)
    views = (np.asarray(jt.translation(dz=-10.0))[None]
             @ np.asarray(janim.default_sway(5.0).batch(
                 janim.frame_times(2, 60.0))))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(render_clip(mesh, camera.projection, views, w, h,
                                      impl=impl, frame_batch=2))


# The grid route's CLI plumbing is the Pallas route's (render_clip's impl);
# its frames are held against JAX in the frame tests above.
@pytest.mark.parametrize("impl", ["pallas"])
def test_cli_tiled_end_to_end(tmp_path, impl):
    """The port's CLI on a PNG pair writes frames that meet the frame bar
    against the JAX package's render_clip."""
    from depthrenderer_tpu import video as jvideo

    from depthrenderer_tpu_torch import cli as tcli

    from test_torch_slice import write_png_pair

    cp, dp = write_png_pair(tmp_path)
    out = tmp_path / "out"
    w, h, density = CLI_SIZE
    assert tcli.main([str(cp), str(dp), "-output-path", str(out), "--impl",
                      impl, "--width", str(w), "--height", str(h),
                      "-mesh-density", str(density), *CLI_ARGS]) == 0
    decoded = np.stack(jvideo.read_avi_frames(out / f"{cp.name}.avi"))
    assert decoded.shape == (2, h, w, 3)
    assert (out / "sample_frame.png").stat().st_size > 0
    assert (decoded.max(-1) > 0).mean() > 0.5
    want = _jax_clip(cp, dp, impl)
    for k in range(2):
        frame_bar(decoded[k], want[k, ..., :3])
