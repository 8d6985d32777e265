"""The soup rasteriser, GL's near-plane clip and the float64 oracles of the
port against the JAX package's, on the CPU.

Scenes: ``test_raster.scene(density=3, size=(24, 32))`` (a 9x9 vertex grid,
depth displacement 4) at 64x48: frontal, at ``test_near_clip``'s
straddling pose (the camera so close that part of the mesh sits behind it;
at 64x48 on this scene nothing in front of it reaches a pixel), and
"inside": the camera among the scene's depth spikes (dz = -3.5, yaw 30
degrees), where 13 triangles straddle and their clipped fans take about
14 % of the pixels. The same numpy arrays go into both packages. Bars,
with their reasons:

* ``clip_near_plane`` is host float64 numpy in both: its arrays equal
  JAX's, dtypes included.
* ``rasterize_reference`` computes the same float64 expressions in the same
  order: frames equal JAX's numpy oracle byte for byte.
* ``rasterize_soup`` rounds each float32 expression as XLA's CPU backend
  rounds the JAX function under ``jit``: >= 60 dB with <= 0.1 % of pixels
  off by more than 1 LSB (the tiled tests' cross-package bar), the
  ``texture_z`` depth equal up to rounding (4 ulp); in practice equal.
  Where a clipped fan reaches a pixel ("inside") the two soups part: JAX's
  clips at ``clip_w = 1e-9``, whose crossing vertices lie near 1e10 in
  window coordinates, beyond float32's reach, and leaves its own oracle on
  those pixels; the port's clips at GL's near plane
  (``raster_reference.clip_gl_near``) and meets the JAX package's
  soup-against-oracle bar there (>= 30 dB, <= 3 %, ``test_near_clip.py:72``).
* Tiling the pixels, and the chunks each tile skips, change no pixel: the
  frames are byte-identical.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from depthrenderer_tpu.ops import raster_grid as jrg
from depthrenderer_tpu.ops import raster_reference as jref
from depthrenderer_tpu.ops import raster_soup as jsoup
from depthrenderer_tpu.ops.common import suggest_config as jsuggest
from depthrenderer_tpu.utils import psnr

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch import transforms as tt
from depthrenderer_tpu_torch.ops import common as tcommon
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_reference as tref
from depthrenderer_tpu_torch.ops import raster_soup as tsoup
from depthrenderer_tpu_torch.render import clip_mvps
from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture
from depthrenderer_tpu_torch.synthetic import synthetic_scene

from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu.transforms import Axis
from test_near_clip import _straddling_pose
from test_raster import scene

torch.set_num_threads(1)

W, H = 64, 48
CULL = 2.0


@functools.lru_cache(maxsize=None)
def soup_scene():
    """(vertices, uvs, indices, {pose name: MVP})."""
    verts, uvs, idx, mvp, _ = scene(density=3, size=(24, 32), seed=0)
    inside = (np.asarray(jt.perspective(18.0, 32 / 24))
              @ np.asarray(jt.translation(dz=-3.5))
              @ np.asarray(jt.rotation(np.deg2rad(30.0), axis=Axis.Y)))
    return (verts.astype(np.float32), uvs.astype(np.float32), idx,
            {"frontal": mvp.astype(np.float32), "straddle": _straddling_pose(),
             "inside": inside.astype(np.float32)})


def pose(name):
    return soup_scene()[3][name]


def covered_share(frame):
    return float((frame[..., :3].max(-1) > 0).mean())


def frame_bar(got, want, min_psnr=60.0, max_off=0.001):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    p, off = psnr(got, want), float((diff > 1).mean())
    assert got.shape == want.shape
    assert p >= min_psnr and off <= max_off, (p, off)


def z_bar(got, want):
    """Depths equal up to 4 ulp where covered; FAR_SENTINEL alike."""
    far_g, far_w = got >= 1e38, want >= 1e38
    assert (far_g == far_w).mean() >= 0.999
    both = ~far_g & ~far_w
    ulp = np.spacing(np.abs(want[both]).astype(np.float32))
    assert (np.abs(got[both] - want[both]) <= 4 * ulp).all()


@pytest.mark.parametrize("name", ["straddle", "inside", "frontal"])
def test_clip_near_plane_equals_jax(name):
    verts, uvs, idx = soup_scene()[:3]
    want = jref.clip_near_plane(verts, uvs, idx, pose(name))
    got = tref.clip_near_plane(torch.from_numpy(verts), uvs, idx, pose(name))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if name != "frontal":
        assert len(got[0]) > len(verts)
        assert len(got[2]) != len(idx)
    else:   # the fast exit: the inputs as they are
        np.testing.assert_array_equal(got[2], idx)


@pytest.mark.parametrize("name", ["straddle", "inside"])
@pytest.mark.parametrize("mode", ["texture", "debug_z", "wireframe"])
@pytest.mark.parametrize("cull", [None, CULL], ids=["no-cull", "cull"])
def test_reference_equals_jax_oracle(checker_texture, name, mode, cull):
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose(name)
    want = jref.rasterize_reference(verts, uvs, idx, mvp, checker_texture, W,
                                    H, mode=mode, edge_cull_threshold=cull)
    got = tref.rasterize_reference(torch.from_numpy(verts), uvs, idx, mvp,
                                   checker_texture, W, H, mode=mode,
                                   edge_cull_threshold=cull)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "inside" and mode != "wireframe":
        assert covered_share(want) > 0.3


@pytest.mark.parametrize("name", ["straddle", "frontal"])
@pytest.mark.parametrize("mode", ["texture", "debug_z", "wireframe",
                                  "texture_z"])
@pytest.mark.parametrize("cull", [None, CULL], ids=["no-cull", "cull"])
def test_soup_equals_jax(checker_texture, name, mode, cull):
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose(name)
    want = jsoup.rasterize_soup(verts, uvs, idx, mvp,
                                checker_texture.astype(np.float32), W, H,
                                mode=mode, edge_cull_threshold=cull)
    got = tsoup.rasterize_soup(torch.from_numpy(verts), uvs, idx, mvp,
                               checker_texture, W, H, mode=mode,
                               edge_cull_threshold=cull)
    if mode == "texture_z":
        z_bar(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    want = np.asarray(want)
    frame_bar(got.numpy(), want)
    if name == "frontal" and mode != "wireframe":
        assert covered_share(want) > 0.3


@pytest.mark.parametrize("name", ["straddle", "inside"])
@pytest.mark.parametrize("mode", ["texture", "debug_z", "wireframe"])
def test_soup_against_oracle_at_straddling_poses(checker_texture, name,
                                                 mode):
    """The JAX package's own bar for its soup against its oracle at a
    straddling pose (``test_near_clip.py:72``); at "inside", where clipped
    fans take about 14 % of the pixels, JAX's soup misses it."""
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose(name)
    oracle = tref.rasterize_reference(verts, uvs, idx, mvp, checker_texture,
                                      W, H, mode=mode).numpy()
    got = tsoup.rasterize_soup(torch.from_numpy(verts), uvs, idx, mvp,
                               checker_texture, W, H, mode=mode).numpy()
    diff = np.abs(got.astype(int) - oracle.astype(int)).max(-1)
    assert (diff > 8).mean() <= 0.03
    assert psnr(got[diff <= 8], oracle[diff <= 8]) >= 30.0
    if name == "inside" and mode == "texture":
        assert covered_share(oracle) > 0.3
        want = np.asarray(jsoup.rasterize_soup(
            verts, uvs, idx, mvp, checker_texture.astype(np.float32), W, H))
        jdiff = np.abs(want.astype(int) - oracle.astype(int)).max(-1)
        assert (jdiff > 8).mean() > 0.05


def test_gl_near_clip_keeps_what_is_in_front(checker_texture):
    """Every vertex the clipped triangles use lies on or in front of GL's
    near plane, and the clipped soup through the float64 oracle renders
    the oracle's own frame (the pixels the near plane drops are those its
    z test drops)."""
    verts, uvs, idx = soup_scene()[:3]
    for name in ("inside", "straddle", "frontal"):
        mvp = pose(name)
        v2, uv2, idx2 = tref.clip_gl_near(verts, uvs, idx, mvp)
        d = tref.near_depth(v2, mvp)[np.unique(idx2)]
        assert d.min() > -1e-12
        if name == "frontal":
            np.testing.assert_array_equal(idx2, idx)
            continue
        assert len(v2) > len(verts)
        got = tref.rasterize_reference(v2, uv2, idx2, mvp, checker_texture,
                                       W, H).numpy()
        want = tref.rasterize_reference(verts, uvs, idx, mvp,
                                        checker_texture, W, H).numpy()
        diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
        assert (diff > 1).mean() <= 0.002


@pytest.mark.parametrize("second", [1, 5], ids=["same-chunk", "next-chunk"])
def test_duplicate_triangle_lowest_id_wins(checker_texture, second):
    """A visible triangle drawn again at id ``second`` over its own corners
    with other UVs: every pixel both cover is an exact depth tie, which the
    lower id wins, within a chunk of 4 (min's first index) and across
    chunks (the strict merge), in the port's soup, JAX's soup and the
    oracle; with the duplicate drawn first the frame changes."""
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose("frontal")
    tri = idx.reshape(-1, 3).astype(np.int64)
    t = 2 * (4 * 8 + 4)   # a triangle of the grid's centre cell
    others = np.delete(tri, t, axis=0)
    dup = np.arange(len(verts), len(verts) + 3)[None]
    verts2 = np.concatenate([verts, verts[tri[t]]])
    uvs2 = np.concatenate([uvs, 1.0 - uvs[tri[t]]])

    def soup(order, pkg="port"):
        flat = np.concatenate(order).reshape(-1)
        if pkg == "jax":
            return np.asarray(jsoup.rasterize_soup(
                verts2, uvs2, flat, mvp, checker_texture.astype(np.float32),
                W, H, chunk_tris=4))
        if pkg == "oracle":
            return tref.rasterize_reference(verts2, uvs2, flat, mvp,
                                            checker_texture, W, H).numpy()
        return tsoup.rasterize_soup(torch.from_numpy(verts2), uvs2, flat,
                                    mvp, checker_texture, W, H,
                                    chunk_tris=4).numpy()

    tied = [tri[t:t + 1], others[:second - 1], dup, others[second - 1:]]
    base = [tri[t:t + 1], others]
    for pkg in ("port", "jax", "oracle"):
        np.testing.assert_array_equal(soup(tied, pkg), soup(base, pkg))
    flipped = soup([dup, tri[t:t + 1], others])
    assert (flipped != soup(base)).any(-1).sum() > 10


@pytest.mark.parametrize("name", ["inside", "frontal"])
def test_pixel_tiles_change_no_pixel(checker_texture, name):
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose(name)
    whole = tsoup.rasterize_soup(torch.from_numpy(verts), uvs, idx, mvp,
                                 checker_texture, W, H, mode="texture_z",
                                 chunk_tris=16)
    for tile in (1, 3 * W + 5):   # one row a step; three rows a step
        part = tsoup.rasterize_soup(torch.from_numpy(verts), uvs, idx, mvp,
                                    checker_texture, W, H, mode="texture_z",
                                    chunk_tris=16, pixel_tile=tile)
        np.testing.assert_array_equal(part[0].numpy(), whole[0].numpy())
        np.testing.assert_array_equal(part[1].numpy(), whole[1].numpy())
    # The row steps skip chunks: the test holds only if some are skipped.
    planes = tsoup.soup_planes(
        torch.from_numpy(verts), torch.from_numpy(uvs),
        torch.from_numpy(idx.astype(np.int64)).reshape(-1, 3),
        torch.from_numpy(mvp), W, H)[0]
    planes = planes[:len(planes) // 16 * 16].reshape(-1, 16, 4, 3).permute(
        0, 2, 3, 1)
    one = torch.ones(1)
    reach = tsoup.chunks_reaching(planes, 0.5 * one, (W - 0.5) * one,
                                  (H - 0.5) * one, (H - 0.5) * one)
    assert 0 < int(reach.sum()) < len(reach)


def test_grid_texture_z_equals_jax(checker_texture):
    verts, uvs = soup_scene()[:2]
    mvp = pose("frontal")
    n = 9
    cfg = jsuggest(n, W, H, tile_h=8, tile_w=32, map_batch=4)
    tex = checker_texture.astype(np.float32)
    want = jrg.render_frame_grid(jnp.asarray(mvp), verts.reshape(n, n, 3),
                                 uvs.reshape(n, n, 2), tex, W, H, cfg,
                                 "texture_z")
    got = trg.render_frame_grid(
        torch.from_numpy(mvp), torch.from_numpy(verts).reshape(n, n, 3),
        torch.from_numpy(uvs).reshape(n, n, 2), torch.from_numpy(tex), W, H,
        convert.raster_config_from_jax(cfg.__dict__), "texture_z")
    frame_bar(got[0].numpy(), np.asarray(want[0]))
    z_bar(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy() < tcommon.FAR_SENTINEL).mean() > 0.3
    plain = trg.render_frame_grid(
        torch.from_numpy(mvp), torch.from_numpy(verts).reshape(n, n, 3),
        torch.from_numpy(uvs).reshape(n, n, 2), torch.from_numpy(tex), W, H,
        convert.raster_config_from_jax(cfg.__dict__))
    np.testing.assert_array_equal(plain.numpy(), got[0].numpy())


@pytest.mark.parametrize("name", ["straddle", "inside"])
@pytest.mark.parametrize("cull", [None, CULL], ids=["no-cull", "cull"])
def test_grid_rows_equal_reference_at_straddling_poses(checker_texture, name,
                                                       cull):
    verts, uvs, idx = soup_scene()[:3]
    mvp = pose(name)
    n = 9
    vg = torch.from_numpy(verts).reshape(n, n, 3)
    uvg = torch.from_numpy(uvs).reshape(n, n, 2)
    assert trg.straddling_triangles(mvp, vg) > 0
    want = tref.rasterize_reference(verts, uvs, idx, mvp, checker_texture,
                                    W, H, edge_cull_threshold=cull).numpy()
    rows = [0, 7, 20, 31, 47]
    got = tref.rasterize_grid_rows(torch.from_numpy(mvp), vg, uvg,
                                   checker_texture, W, H, rows, cull)
    np.testing.assert_array_equal(got.numpy(), want[rows])
    whole = tref.rasterize_grid_rows(torch.from_numpy(mvp), vg, uvg,
                                     checker_texture, W, H, range(H), cull)
    np.testing.assert_array_equal(whole.numpy(), want)


def test_binning_leaves_out_corners_behind_the_camera(checker_texture):
    """With no vertex behind the camera the tile bounds are JAX's. With
    some (the smoke's synthetic scene at mesh density 6 and 128x72, the
    close pose ``translation(dz=-3) @ rotation(20 degrees, Y)``), their
    sign-flipped projections stretch no window: the widest span shrinks.
    The control, which composes the straddlers' clipped soup, equals the
    float64 row oracle where the soup takes pixels ("inside")."""
    colour, depth = synthetic_scene()
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth, density=6)
    mesh.vertices[:, 2] *= 4.0
    n, w, h = 65, 128, 72
    vg, uvg = mesh.vertices.reshape(n, n, 3), mesh.texture_coordinates.reshape(
        n, n, 2)
    proj = Camera((640, 480), fov_y=18.0).projection
    cfg = tcommon.suggest_config(n, w, h)
    spans = {}
    for name, dz, yaw in (("far", -10.0, 0.0), ("close", -3.0, 20.0)):
        view = tt.matmul(tt.translation(dz=dz),
                         tt.rotation(np.deg2rad(yaw), axis=tt.Axis.Y))
        mvp = clip_mvps(proj, view[None], mesh.transform)[0]
        g = trg._padded_grid(mvp, vg, uvg, w, h, cfg)
        args = (cfg, w, h, -(-h // 8), -(-w // 128))
        plain = trg._tile_bounds(g[0], g[1], *args)
        masked = trg._tile_bounds(g[0], g[1], *args, g[3])
        spans[name] = [int((b[k + 1] - b[k]).max()) for b in (plain, masked)
                       for k in (0, 2)]
        if name == "far":
            assert not (g[3] <= 0).any()
            for a, b in zip(plain, masked):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (g[3] <= 0).any()
    rows, cols, rows_m, cols_m = spans["close"]
    assert rows_m <= rows and cols_m < cols, spans

    verts, uvs = soup_scene()[:2]
    vg = torch.from_numpy(verts).reshape(9, 9, 3)
    uvg = torch.from_numpy(uvs).reshape(9, 9, 2)
    mvp = torch.from_numpy(pose("inside"))
    control, stats = trg.render_frame_grid_exact(
        mvp, vg, uvg, checker_texture, W, H, strips=2, with_stats=True)
    assert stats["straddlers"] > 0 and stats["soup_won"] > 0
    oracle = tref.rasterize_grid_rows(mvp, vg, uvg, checker_texture, W, H,
                                      range(H))
    diff = np.abs(control.astype(int) - oracle.numpy().astype(int)).max(-1)
    assert (diff > 1).mean() <= 0.002
