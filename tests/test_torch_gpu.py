"""The scan kernels on an NVIDIA GPU against their plain PyTorch twins.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Scene: a seeded sinusoid depth map with a raised step and a noisy patch,
meshed at density 7 (a 129x129 grid, cw = 256: narrow and wide marches) and
rendered at 128x96, frontal and 4 degrees yawed, for every ported
(hyps, colfix) pair. Bars, with their reasons: the kernels compute the same
float32 operations in the same order as their twins (the kernel file is built
with ``--fmad=false``), so records, attributes and pixels must be equal.
Across devices (``render_clip`` on the card against the plain passes on the
CPU) the prep's PyTorch ops run on different backends; the bar there is the
chip smoke's: at least 99.9% of pixels byte-identical and at most 0.1% off
by more than 1 LSB.
"""

import numpy as np
import pytest
import torch

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation, transforms
from depthrenderer_tpu_torch.ops import raster_scan as rs
from depthrenderer_tpu_torch.render import clip_mvps, render_clip

pytestmark = pytest.mark.gpu

W, H, DENSITY = 128, 96, 7
N = 2**DENSITY + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene_mesh(seed=0, density=DENSITY):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:64]
    d = 127 + 100 * np.sin(xx / 64 * 6) * np.cos(yy / 48 * 4)
    d[16:24, 16:32] = 250
    d[24:30, 32:40] = rng.integers(0, 256, (6, 8))
    colour = rng.integers(0, 256, (48, 64, 3), np.uint8)
    mesh = tdr.Mesh.from_texture(tdr.Texture(colour),
                                 depth_map=np.clip(d, 0, 255).astype(np.uint8),
                                 density=density)
    mesh.vertices[:, 2] *= 4.0
    return mesh


def scene_mvps(width=W):
    base = transforms.matmul(transforms.perspective(18.0, width / H),
                             transforms.translation(dz=-15.0))
    yaw = transforms.rotation(torch.tensor(np.deg2rad(4.0), dtype=torch.float32),
                              axis=transforms.Axis.Y)
    return torch.stack([base, transforms.matmul(base, yaw)])


@pytest.mark.parametrize("hyps,colfix", [(1, 1), (2, 1), (1, None),
                                         (2, None)])
def test_kernels_equal_plain_twins(cuda, hyps, colfix):
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, hyps=hyps, colfix=colfix)
    g = rs.ScanGeometry.of(W, H, N, N, cfg)
    mvps = scene_mvps()
    minv = rs.minv_rows(mvps)
    prep = rs.prep_scan(mvps.to(cuda), mesh.vertices.reshape(N, N, 3).to(cuda),
                        W, H, cfg)
    texq = rs.pack_texture(mesh.texture.image.to(cuda))
    rs.reset_launch_counts()
    for i in range(mvps.shape[0]):
        args = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec = rs.solve_records(*args, g, cfg)
        assert torch.equal(rec, rs.solve_records_plain(*args, g, cfg))
        margs = (prep.win[i], prep.w0[i], prep.bounds[i], prep.canch[i],
                 prep.mid[i], minv[i], g, cfg)
        attrs = rs.march_exact(rec, *margs)
        torch.testing.assert_close(attrs, rs.march_exact_plain(rec, *margs),
                                   rtol=0, atol=0, equal_nan=True)
        assert attrs[3].mean() > 0.3
        out = rs.shade(attrs, texq, g, cfg, "texture")
        assert torch.equal(out, rs.shade_plain(attrs, texq, *texq.shape,
                                               "texture"))
    assert rs.LAUNCHES == {"solve": 2, "march": 2, "shade": 2}


def test_render_clip_on_the_card_matches_the_cpu(cuda):
    mesh = scene_mesh()
    proj = tdr.Camera((64, 48), fov_y=18.0).projection
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)[::60]))
    on_card = render_clip(mesh, proj, views, W, H, frame_batch=2,
                          device="cuda")
    on_cpu = render_clip(mesh, proj, views, W, H, frame_batch=2, device="cpu")
    assert on_card.shape == on_cpu.shape == (5, H, W, 4)
    diff = np.abs(on_card.astype(int) - on_cpu.astype(int)).max(axis=-1)
    assert (diff == 0).mean() >= 0.999 and (diff > 1).mean() <= 0.001
    assert clip_mvps(proj, views, mesh.transform).shape == (5, 4, 4)


def test_wrappers_reject_bad_inputs(cuda):
    cfg = rs.suggest_scan_config(N, W, H)
    g = rs.ScanGeometry.of(W, H, N, N, cfg)
    win = torch.zeros((3, g.rpad, g.cl), device=cuda)
    w0 = torch.zeros((g.nbands,), dtype=torch.int32, device=cuda)
    bounds = torch.zeros((g.nbands * g.nchunks,), dtype=torch.int32,
                         device=cuda)
    with pytest.raises(ValueError, match="win must be"):
        rs.solve_records(win.double(), w0, bounds, g, cfg)
    with pytest.raises(ValueError, match="mixed devices"):
        rs.solve_records(win.cpu(), w0, bounds, g, cfg)
    rec = rs.solve_records(win, w0, bounds, g, cfg)   # empty bounds: no records
    assert bool((rec[:, :, 2] == -1.0e9).all())


def test_soup_on_the_card_equals_the_cpu(cuda):
    """The soup (plain PyTorch on both devices, float32 elementwise with
    the exact fma) at a pose where clipped fans take pixels: frames and
    depths equal bit for bit; the float64 oracle on the card against the
    CPU's within 1 LSB; ``min`` takes the first index among equal minima."""
    from depthrenderer_tpu_torch.ops import raster_grid as trg
    from depthrenderer_tpu_torch.ops import raster_reference as ref
    from depthrenderer_tpu_torch.ops import raster_soup

    key = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]] * 3, device=cuda)
    assert key.min(dim=1).indices.tolist() == [1, 1, 1]
    mesh = scene_mesh(density=5)
    view = transforms.matmul(transforms.translation(dz=-1.5),
                             transforms.rotation(0.3, axis=transforms.Axis.Y))
    mvp = clip_mvps(transforms.perspective(18.0, W / H), view[None],
                    mesh.transform)[0]
    n = 33
    tris = trg.straddlers(mvp, mesh.vertices.reshape(n, n, 3))
    assert len(tris) > 0
    args = (mesh.vertices, mesh.texture_coordinates, mesh.indices, mvp,
            mesh.texture.image, W, H)
    rgba, z = raster_soup.rasterize_soup(*args, mode="texture_z")
    rgba_c, z_c = raster_soup.rasterize_soup(
        mesh.vertices.to(cuda), *args[1:], mode="texture_z")
    assert torch.equal(rgba_c.cpu(), rgba) and torch.equal(z_c.cpu(), z)
    assert (z < 1e38).float().mean() > 0.2
    oracle = ref.rasterize_reference(*args)
    oracle_c = ref.rasterize_reference(mesh.vertices.to(cuda), *args[1:])
    assert (oracle_c.cpu().int() - oracle.int()).abs().max() <= 1


def test_yuv_pack_on_the_card_equals_the_cpu(cuda):
    """The farm's YUV 4:2:0 pack: eager elementwise operations, nothing
    contracted, so the card's bytes equal the CPU's."""
    from depthrenderer_tpu_torch import io as tio

    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 480, 640, 4), dtype=np.uint8))
    on_card = tio.rgba_to_yuv420(frames.to(cuda))
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), tio.rgba_to_yuv420(frames))


def test_sharded_scan_dispatch_waits_for_nothing(cuda):
    """One chunk of the sharded farm's dispatch, ``render_scenes_sharded``
    on the scan (grids on the card, UV grids checked by the caller) and the
    YUV pack, under CUDA's sync debug mode "error": nothing in it waits for
    the card. Its frames equal ``render_clip``'s."""
    from depthrenderer_tpu_torch import io as tio
    from depthrenderer_tpu_torch.parallel import render_scenes_sharded

    meshes = [scene_mesh(seed) for seed in (0, 1)]
    vgrids = [m.vertices.reshape(N, N, 3).to(cuda) for m in meshes]
    textures = [m.texture.image.to(cuda) for m in meshes]
    mvps = clip_mvps(scene_mvps()[:1], torch.eye(4)[None],
                     meshes[0].transform)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames = render_scenes_sharded(mvps.expand(2, -1, -1, -1), vgrids,
                                       None, textures, W, H, impl="scan",
                                       devices=[cuda])
        packed = [tio.rgba_to_yuv420(f) for f in frames]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for mesh, f, p in zip(meshes, frames, packed):
        want = render_clip(mesh, scene_mvps()[:1], torch.eye(4)[None], W, H,
                           device="cuda")
        assert np.array_equal(f.cpu().numpy(), want)
        assert torch.equal(p.cpu(), tio.rgba_to_yuv420(torch.from_numpy(want)))


def test_sixth_plane_march_equals_twin(cuda):
    """The quality tier's wireframe passes: the march's attrs with the sixth
    plane (ml / ar, coverage ungated) against the twin's, max abs 0, for
    both passes; the merged frames on the card against the CPU's at the
    cross-device bar."""
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, quality=True)
    cfg1, cfg2 = rs.tier_configs(cfg, N, N, W, H)
    vgrid = mesh.vertices.reshape(N, N, 3)
    mvps = scene_mvps()
    for c, mv, vg, w, h in ((cfg1, mvps, vgrid, W, H),
                            (cfg2, rs.swap_mvps(mvps),
                             vgrid.transpose(0, 1).contiguous(), H, W)):
        g = rs.ScanGeometry.of(w, h, N, N, c)
        minv = rs.minv_rows(mv)
        prep = rs.prep_scan(mv.to(cuda), vg.to(cuda), w, h, c)
        for i in range(mv.shape[0]):
            args = (prep.win[i], prep.w0[i], prep.bounds[i])
            rec = rs.solve_records(*args, g, c)
            margs = (rec, *args, prep.canch[i], prep.mid[i], minv[i], g, c)
            attrs = rs.march_exact(*margs, min_lam=True)
            assert attrs.shape[0] == 6
            torch.testing.assert_close(
                attrs, rs.march_exact_plain(*margs, min_lam=True), rtol=0,
                atol=0, equal_nan=True)
            assert 0 < float((attrs[5] > 0).float().mean())
    uvg = mesh.texture_coordinates.reshape(N, N, 2)
    frames = [rs.unpack_raw_frames(rs.render_frames_scan(
        mvps, vgrid.to(dev), uvg.to(dev), mesh.texture.image.to(dev), W, H,
        cfg, "wireframe")[0].cpu(), W, H) for dev in (cuda, "cpu")]
    diff = np.abs(frames[0].astype(int) - frames[1].astype(int)).max(-1)
    assert (diff == 0).mean() >= 0.999 and (diff > 1).mean() <= 0.001


def test_batch_on_the_card_equals_render_clip(cuda, tmp_path):
    """``batch.main`` on the card, sequential and sharded (the auto readback:
    YUV 4:2:0 on the card), against ``render_clip`` on the card model by
    model: the sequential AVI holds the native JPEGs of its frames, the
    sharded one the native YUV encodes of their YUV pack."""
    from PIL import Image

    from depthrenderer_tpu_torch import batch, native
    from depthrenderer_tpu_torch import io as tio
    from depthrenderer_tpu_torch import video

    yy, xx = np.mgrid[0:48, 0:64]
    colour = np.stack([xx * 4, yy * 5, ((xx // 8 + yy // 8) % 2) * 200 + 27],
                      axis=-1).astype(np.uint8)
    Image.fromarray(colour).save(tmp_path / "scene.png")
    models = ("ground_truth", "model_a")
    for k, m in enumerate(models):
        d = 120 + 90 * np.sin(xx / 64 * (6 + k)) * np.cos(yy / 48 * 4)
        (tmp_path / "models" / m).mkdir(parents=True)
        Image.fromarray(np.clip(d, 0, 255).astype(np.uint8)).save(
            tmp_path / "models" / m / "scene.png")
    frames = 8
    for name, extra in (("seq", []), ("sharded", ["--sharded"])):
        assert batch.main([str(tmp_path / "scene.png"),
                           str(tmp_path / "models"), "-mesh-density", "6",
                           "--frames", str(frames), "--no-post",
                           "-output-path", str(tmp_path / name)] + extra) == 0
    ld = tio.load_colour(tmp_path / "scene.png")
    proj = tdr.Camera((64, 48), fov_y=18.0).projection
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway(5.0).batch(animation.frame_times(frames,
                                                                60.0)))
    for m in models:
        depth = tio.resize(tio.load_depth(tmp_path / "models" / m /
                                          "scene.png"), ld.shape)
        mesh = tdr.Mesh.from_texture(tdr.Texture(ld), depth, density=6)
        mesh.vertices[:, 2] *= 4.0
        want = render_clip(mesh, proj, views, 64, 48, device="cuda")
        seq = tmp_path / "seq" / "single_videos" / "scene" / f"{m}.avi"
        sh = tmp_path / "sharded" / "single_videos" / "scene" / f"{m}.avi"
        assert video.read_avi_payloads(seq) == [
            video.encode_jpeg(f[..., :3]) for f in want]
        packed = tio.rgba_to_yuv420(torch.from_numpy(want)).numpy()
        assert video.read_avi_payloads(sh) == [
            native.jpeg_encode_yuv420(*tio.yuv420_planes(p, 48, 64))
            for p in packed]
