"""The port's interactive surface against the JAX package's, on the CPU:
``Camera``'s navigation, the stateful animation API, ``Mesh`` copies and
``MeshRenderer``'s frame loop on every route.

Counterparts of ``tests/test_render_cli.py:29-117`` and
``tests/test_camera_misc.py:23-66, 90-138``, with ``device="cpu"`` and the
route given explicitly. Scenes as there: ``small_mesh`` (a seeded 24x32
depth map at mesh density 3, depth displacement 4) at 64x48, the camera at
dz = -10, the reference's sway. Bars, with their reasons:

* The camera's matrices are built by the same numpy operations as JAX's:
  equal bit for bit. The stateful animation runs the same float32
  operations at one time, where ``sin`` and ``cos`` are the libraries'
  (torch's and XLA's CPU kernels round a lone element differently from a
  vectorised batch): within 2 ulp of JAX's, and bit for bit the port's own
  batch at that time.
* The loop and ``render_clip`` form the same MVPs with the same function
  (``render.clip_mvps``) and render through the same functions: frames
  equal byte for byte.
* Against JAX's ``MeshRenderer`` (its MVP a numpy float32 product, the
  port's an index-order sum): the tiled tests' cross-package bar, >= 60 dB
  with <= 0.2 % of pixels off by more than 1 LSB.
"""

import numpy as np
import pytest
import torch

from depthrenderer_tpu import animation as janim
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu.ops.common import RasterConfig as JRasterConfig
from depthrenderer_tpu.render import MeshRenderer as JMeshRenderer
from depthrenderer_tpu.scene import Camera as JCamera
from depthrenderer_tpu.scene import Mesh as JMesh
from depthrenderer_tpu.scene import Texture as JTexture
from depthrenderer_tpu.utils import psnr

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation as tanim
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import transforms as tt
from depthrenderer_tpu_torch.ops import raster_scan as trs
from depthrenderer_tpu_torch.ops.common import RasterConfig
from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture

torch.set_num_threads(1)

CFG = RasterConfig(tile_h=8, tile_w=32, window_rows=8, window_cols=8,
                   patch_size=4, map_batch=4)
JCFG = JRasterConfig(tile_h=8, tile_w=32, window_rows=8, window_cols=8,
                     patch_size=4, map_batch=4)
BG = np.array([0, 0, 0, 255], np.uint8)


def depth_map():
    return np.random.default_rng(0).integers(0, 256, size=(24, 32),
                                             dtype=np.uint8)


def small_mesh(checker_texture, density=3):
    mesh = Mesh.from_texture(Texture(checker_texture), depth_map(),
                             density=density)
    mesh.vertices[:, 2] *= 4.0
    return mesh


def small_jax_mesh(checker_texture, density=3):
    mesh = JMesh.from_texture(JTexture(checker_texture), depth_map(),
                              density=density)
    mesh.vertices[:, 2] *= 4.0
    return mesh


def frame_bar(got, want, min_psnr=60.0, max_off=0.002):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    p, off = psnr(got, want), float((diff > 1).mean())
    assert got.shape == want.shape
    assert p >= min_psnr and off <= max_off, (p, off)


def renderer(camera, impl, **kw):
    cfg = CFG if impl in ("grid", "pallas") else None
    return trender.MeshRenderer(camera=camera, config=cfg, impl=impl,
                                device="cpu", **kw)


def covered(frame):
    return int((~(frame == BG).all(-1)).sum())


# -- Camera (reference render.py:14-180) ------------------------------------

def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def ulp_close(got, want, n=2):
    want = np.asarray(want, np.float32)
    assert got.dtype == want.dtype
    np.testing.assert_array_less(np.abs(got - want),
                                 n * np.spacing(np.abs(want)) + 1e-45)


def test_camera_navigation_equals_jax():
    for size, fov in (((200, 100), 60.0), ((640, 480), 5.0)):
        ours, theirs = Camera(size, fov_y=fov), JCamera(size, fov_y=fov)
        steps = [("zoom_in",), ("zoom_in",), ("zoom_out",), ("zoom_out",),
                 ("zoom_out",), ("pan", 20, 10), ("rotate", 100, 50),
                 ("pan", -7.5, 3), ("rotate", -31, 12), ("reset_zoom",),
                 ("zoom_in",)]
        for name, *args in steps:
            getattr(ours, name)(*args)
            getattr(theirs, name)(*args)
            assert ours.fov_y == theirs.fov_y
            for attr in ("projection", "view", "view_projection_matrix"):
                got, want = _np(getattr(ours, attr)), getattr(theirs, attr)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=attr)
        assert (ours.original_fov_y, ours.zoom_speed, ours.near_zoom_rate,
                ours.rotation_speed) == (theirs.original_fov_y,
                                         theirs.zoom_speed,
                                         theirs.near_zoom_rate,
                                         theirs.rotation_speed)


def test_camera_zoom_rules():
    # Reference zoom semantics (render.py:94-121): +speed above the
    # threshold, multiplicative near zero, reset restores the original.
    cam = Camera(window_size=(100, 100), fov_y=60, zoom_speed=10)
    cam.zoom_in()
    assert cam.fov_y == 70
    cam.zoom_out()
    cam.zoom_out()
    assert cam.fov_y == 50
    cam.reset_zoom()
    assert cam.fov_y == 60
    np.testing.assert_array_equal(cam.projection.numpy(),
                                  Camera((100, 100), fov_y=60).projection)
    near = Camera(window_size=(100, 100), fov_y=5, zoom_speed=10)
    near.zoom_in()
    assert near.fov_y == pytest.approx(5 * 1.05)
    near.zoom_out()
    assert near.fov_y == pytest.approx(5 * 1.05 * 0.9)


def test_camera_pan_and_rotate_update_view():
    cam = Camera(window_size=(200, 100))
    v0 = cam.view.clone()
    cam.pan(20, 10)
    assert not torch.allclose(cam.view, v0)
    # Pan is normalised by the window size (render.py:158).
    assert float(cam.view[0, 3]) == pytest.approx(20 / 200)
    assert float(cam.view[1, 3]) == pytest.approx(10 / 100)
    cam2 = Camera(window_size=(200, 100))
    cam2.rotate(100, 50)
    r = cam2.view[:3, :3].numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert not np.allclose(r, np.eye(3))
    np.testing.assert_allclose(cam2.view_projection_matrix.numpy(),
                               (cam2.projection @ cam2.view).numpy(),
                               rtol=1e-6)


# -- the stateful animation (reference animation.py:6-27, 92-119) -----------

def test_stateful_animation_equals_jax():
    cases = [(tanim.default_sway(1.0), janim.default_sway(1.0)),
             (tanim.RotateXYBounce(0.3, speed=0.7, offset=0.1),
              janim.RotateXYBounce(0.3, speed=0.7, offset=0.1)),
             (tanim.Translate(0.4, axis=tt.Axis.Z, speed=2.0),
              janim.Translate(0.4, axis=jt.Axis.Z, speed=2.0))]
    other = np.array(jt.translation(dz=-10.0))
    for ours, theirs in cases:
        ulp_close(ours.transform.numpy(), theirs.transform)
        for delta in (1 / 24, 1 / 24, 0.3, 1 / 60):
            ours.update(delta)
            theirs.update(delta)
            assert ours.elapsed == theirs.elapsed
            got = ours.transform.numpy()
            ulp_close(got, theirs.transform)
            t = torch.full((1,), ours.elapsed, dtype=torch.float32)
            np.testing.assert_array_equal(got, ours.batch(t)[0].numpy())
            np.testing.assert_allclose(
                ours.apply(torch.from_numpy(other)).numpy(),
                theirs.apply(other), rtol=1e-6, atol=1e-6)
        if isinstance(ours, tanim.Compose):
            assert all(a.elapsed == ours.elapsed for a in ours.animations)
        ours.reset()
        theirs.reset()
        assert ours.elapsed == 0.0
        if isinstance(ours, tanim.Compose):
            assert all(a.elapsed == 0.0 for a in ours.animations)
        ulp_close(ours.transform.numpy(), theirs.transform)


def test_stateful_transform_is_the_batch_at_its_time():
    sway = tanim.default_sway(1.0)
    batch = sway.batch(tanim.frame_times(5, 24.0))
    for k in range(5):
        sway.update(1 / 24)
        np.testing.assert_array_equal(sway.transform.numpy(),
                                      batch[k].numpy())


# -- scene copies -------------------------------------------------------------

def test_mesh_copy_with_new_depth_equals_jax(checker_texture):
    ours, theirs = small_mesh(checker_texture), small_jax_mesh(
        checker_texture)
    ours.transform = tt.translation(dx=0.5)
    theirs.transform = np.asarray(jt.translation(dx=0.5))
    new_depth = np.random.default_rng(7).integers(0, 256, (30, 40),
                                                  dtype=np.uint8)
    got = Mesh.from_copy_with_new_depth(ours, new_depth)
    want = JMesh.from_copy_with_new_depth(theirs, new_depth)
    np.testing.assert_array_equal(got.vertices.numpy(), want.vertices)
    np.testing.assert_array_equal(got.texture_coordinates.numpy(),
                                  want.texture_coordinates)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices)
    np.testing.assert_array_equal(got.transform.numpy(), want.transform)
    assert got.grid_density == 3 and got.texture is not ours.texture
    np.testing.assert_array_equal(got.texture.image.numpy(),
                                  ours.texture.image.numpy())
    np.testing.assert_array_equal(
        tdr.meshgen.grid_depth(new_depth, 3).numpy(),
        np.asarray(jmesh.grid_depth(new_depth, 3)))
    ours.texture.cleanup()
    ours.cleanup()
    flat = Mesh(ours.texture, ours.vertices, ours.texture_coordinates,
                ours.indices)
    with pytest.raises(ValueError, match="grid"):
        Mesh.from_copy_with_new_depth(flat, new_depth)


# -- MeshRenderer (reference render.py:568-861) -------------------------------

def test_mesh_renderer_needs_cuda_unless_asked_for_the_cpu():
    assert tdr.MeshRenderer is trender.MeshRenderer
    assert tdr.render_clip is trender.render_clip
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU box")
    with pytest.raises(RuntimeError, match="cuda"):
        trender.MeshRenderer()
    assert trender.MeshRenderer(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("impl", ["grid", "scan"])
def test_mesh_renderer_loop(checker_texture, impl):
    camera = Camera(window_size=(64, 48), fov_y=18)
    camera.view = tt.matmul(tt.translation(dz=-10.0), camera.view)
    r = renderer(camera, impl, fps=30)
    r.mesh = small_mesh(checker_texture)
    frames, deltas, exited = [], [], []

    def update(delta):
        deltas.append(delta)
        frames.append(r.get_frame())
        if len(frames) >= 4:
            r.close()

    r.on_update = update
    r.on_exit = lambda: exited.append(True)
    r.run()
    assert len(frames) >= 4 and exited == [True]
    assert frames[0].shape == (48, 64, 4) and covered(frames[0]) > 1000
    # Fixed time step: delta is exactly 1/fps (reference render.py:750-755).
    assert all(abs(d - 1 / 30) < 1e-9 for d in deltas)
    assert r.impl == impl and not r.is_running


@pytest.mark.parametrize("impl", ["grid", "scan"])
def test_mesh_renderer_pause_and_modes(checker_texture, impl):
    camera = Camera(window_size=(64, 48), fov_y=18)
    camera.view = tt.matmul(tt.translation(dz=-10.0), camera.view)
    r = renderer(camera, impl)
    r.mesh = small_mesh(checker_texture)
    r.draw()
    tex_frame = r.get_frame()
    r.use_debug_shader()
    r.draw()
    dbg_frame = r.get_frame()
    assert (dbg_frame[..., 0] == dbg_frame[..., 1]).all()
    assert not np.array_equal(tex_frame, dbg_frame)
    r.use_default_shader()
    r.draw()
    np.testing.assert_array_equal(r.get_frame(), tex_frame)
    calls = []
    r.on_update = calls.append
    r.pause(True)
    r.run(max_frames=r.frame_count + 2)
    assert calls == [] and r.frame_count == 5   # paused: draws, no update


@pytest.mark.parametrize("impl", ["grid", "scan", "pallas"])
def test_render_clip_matches_loop(checker_texture, impl):
    mesh = small_mesh(checker_texture)
    camera = Camera(window_size=(64, 48), fov_y=18)
    cam_pos = tt.translation(dz=-10.0)
    fps, frames = 24.0, 6
    views = tt.matmul(cam_pos[None], tanim.default_sway(1.0).batch(
        tanim.frame_times(frames, fps)))
    batched = trender.render_clip(
        mesh, camera.projection, views, 64, 48,
        config=CFG if impl != "scan" else None, frame_batch=3, device="cpu",
        impl=impl)
    assert batched.shape == (frames, 48, 64, 4)

    r = renderer(camera, impl, fps=fps)
    r.mesh = mesh
    loop, stateful = [], tanim.default_sway(1.0)

    def update(delta):
        # Reference callback order (__main__.py:143-156): the draw used the
        # current view; the update advances the animation for the next.
        loop.append(r.get_frame())
        stateful.update(delta)
        camera.view = tt.matmul(cam_pos, stateful.transform)
        if len(loop) >= frames:
            r.close()

    stateful.update(1 / fps)   # the first draw sees t = 1/fps, as the batch
    camera.view = tt.matmul(cam_pos, stateful.transform)
    r.on_update = update
    r.run()
    for k in range(frames):
        np.testing.assert_array_equal(loop[k], batched[k])
    if impl != "grid":
        return
    # JAX's loop on its grid route, same views.
    jcam = JCamera(window_size=(64, 48), fov_y=18)
    jr = JMeshRenderer(camera=jcam, fps=fps, config=JCFG)
    jr.mesh = small_jax_mesh(checker_texture)
    jcam.view = views[0].numpy()
    jr.draw()
    frame_bar(loop[0], jr.get_frame())


def test_mesh_renderer_soup_fallback(checker_texture):
    # A hand-built non-grid mesh renders through the soup rasteriser.
    verts = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]],
                     np.float32)
    uvs = np.array([[0, 0], [1, 0], [0.5, 1]], np.float32)
    mesh = Mesh(Texture(checker_texture), verts, uvs, np.array([0, 1, 2]))
    assert not mesh.is_grid
    cam = Camera(window_size=(48, 48), fov_y=60)
    cam.view = tt.matmul(tt.translation(dz=-5.0), cam.view)
    r = trender.MeshRenderer(camera=cam, config=CFG, device="cpu")
    r.mesh = mesh
    assert r.impl == "soup"
    r.draw()
    frame = r.get_frame()
    assert frame.shape == (48, 48, 4) and covered(frame) > 0


@pytest.mark.parametrize("mode", ["texture", "wireframe"])
def test_soup_route_equals_jax_mesh_renderer(checker_texture, mode):
    """A mesh that is not a grid (the small mesh's arrays without its
    density) on both renderers: the port's soup against JAX's."""
    grid, jgrid = small_mesh(checker_texture), small_jax_mesh(
        checker_texture)
    mesh = Mesh(grid.texture, grid.vertices, grid.texture_coordinates,
                grid.indices)
    jmesh_ = JMesh(jgrid.texture, jgrid.vertices, jgrid.texture_coordinates,
                   jgrid.indices)
    views = tt.matmul(tt.translation(dz=-10.0), tt.rotation(
        np.deg2rad(6.0), axis=tt.Axis.Y))
    cam, jcam = Camera((64, 48), fov_y=18), JCamera((64, 48), fov_y=18)
    cam.view, jcam.view = views, views.numpy()
    r = trender.MeshRenderer(camera=cam, mode=mode, impl="scan",
                             device="cpu")
    jr = JMeshRenderer(camera=jcam, mode=mode, impl="soup")
    r.mesh, jr.mesh = mesh, jmesh_
    r.draw()
    jr.draw()
    assert r.impl == "scan"   # asked for, but the mesh is not a grid
    frame_bar(r.get_frame(), jr.get_frame())
    assert covered(r.get_frame()) > 500


@pytest.mark.parametrize("impl", ["grid", "scan", "soup"])
def test_wireframe_toggle_keeps_impl(checker_texture, impl):
    rng = np.random.default_rng(0)
    mesh = Mesh.from_texture(Texture(checker_texture),
                             rng.integers(0, 256, (16, 16), dtype=np.uint8),
                             density=2)
    cam = Camera(window_size=(32, 32), fov_y=18)
    cam.view = tt.matmul(tt.translation(dz=-10.0), cam.view)
    r = trender.MeshRenderer(camera=cam, impl=impl, device="cpu",
                             config=CFG if impl == "grid" else None)
    r.mesh = mesh
    r.draw()
    filled = r.get_frame().copy()
    r.toggle_wireframe()
    assert r.mode == "wireframe" and r.impl == impl
    r.draw()
    wire = r.get_frame().copy()
    assert 0 < covered(wire) < covered(filled)
    r.toggle_wireframe()
    assert r.mode == "texture"


def test_mesh_swap_rederives_an_unpinned_config(checker_texture):
    cam = Camera(window_size=(64, 48), fov_y=18)
    auto = trender.MeshRenderer(camera=cam, impl="grid", device="cpu")
    pinned = trender.MeshRenderer(camera=cam, impl="grid", device="cpu",
                                  config=CFG)
    for density in (2, 4):
        mesh = small_mesh(checker_texture, density)
        auto.mesh = pinned.mesh = mesh
        n = 2**density + 1
        assert auto.config == tdr.ops.common.suggest_config(n, 64, 48)
        assert pinned.config == CFG
    scan = trender.MeshRenderer(camera=cam, device="cpu")
    scan.mesh = small_mesh(checker_texture, 3)
    assert scan.impl == "scan"
    assert scan.config == trs.suggest_scan_config(9, 64, 48)
