"""The PyTorch port's host modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Integer
outputs and float32 values computed by the same operations in the same order
are compared exactly; the one stated exception is float32 sin/cos, which the
two libraries round differently in the last bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import depthrenderer_tpu as jdr
from depthrenderer_tpu import animation as janim
from depthrenderer_tpu import io as jio
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu import video as jvideo
from depthrenderer_tpu.ops import raster_scan as jrs

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation as tanim
from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import convert, native
from depthrenderer_tpu_torch import io as tio
from depthrenderer_tpu_torch import meshgen as tmesh
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import transforms as tt
from depthrenderer_tpu_torch import video as tvideo
from depthrenderer_tpu_torch import writers as twriters
from depthrenderer_tpu_torch.ops import common as tcommon
from depthrenderer_tpu_torch.ops import raster_scan as trs

REPO = Path(__file__).resolve().parent.parent

# One intra-op thread: the suite's worker processes share the cores, and a
# pool of one thread per core in each of them stalls on these small tensors.
torch.set_num_threads(1)

# One float32 ulp relative: the bound for values that pass through sin/cos,
# which XLA and PyTorch round independently (each within an ulp).
ULP_REL = 2.0 ** -23


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_fixed_transforms_equal_jax():
    for jm, tm in [
        (jt.perspective(18.0, 640 / 480), tt.perspective(18.0, 640 / 480)),
        (jt.perspective(37.5, 1.7, 0.2, 50.0), tt.perspective(37.5, 1.7,
                                                              0.2, 50.0)),
        (jt.translation(0.3, -1.5, -10.0), tt.translation(0.3, -1.5, -10.0)),
        (jt.scale(2.5), tt.scale(2.5)),
        (jt.scale(1.0, 2.0, 3.0), tt.scale(1.0, 2.0, 3.0)),
        (jt.identity(), tt.identity()),
    ]:
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        assert _np(tm).dtype == np.float32


@pytest.mark.parametrize("axis", list(tt.Axis))
@pytest.mark.parametrize("degrees", [False, True])
def test_rotation_matches_jax(axis, degrees):
    rng = np.random.default_rng(3)
    angles = rng.uniform(-3.0, 3.0, 16).astype(np.float32)
    if degrees:
        angles *= 57.0
    got = _np(tt.rotation(torch.from_numpy(angles), axis=tt.Axis(axis.value),
                          degrees=degrees))
    want = np.stack([np.asarray(jt.rotation(a, axis=jt.Axis(axis.value),
                                            degrees=degrees))
                     for a in angles])
    # sin/cos round independently in the two libraries: one ulp.
    np.testing.assert_allclose(got, want, rtol=ULP_REL, atol=1e-7)


@pytest.mark.parametrize("density,size", [(0, (5, 7)), (3, (24, 32)),
                                          (5, (48, 64)), (6, (37, 91))])
def test_meshgen_equals_jax(density, size):
    rng = np.random.default_rng(density)
    depth = rng.integers(0, 256, size=size, dtype=np.uint8)
    jv, juv, jidx = (np.asarray(a) for a in jmesh.grid_mesh(depth, density))
    tv, tuv, tidx = tmesh.grid_mesh(depth, density)
    np.testing.assert_array_equal(_np(tv), jv)
    np.testing.assert_array_equal(_np(tuv), juv)
    np.testing.assert_array_equal(_np(tidx).astype(np.int64),
                                  jidx.astype(np.int64))
    assert tmesh.grid_vertex_count(density) == jmesh.grid_vertex_count(density)


def test_animation_batch_matches_jax():
    times = janim.frame_times(300, 60.0)
    np.testing.assert_array_equal(_np(tanim.frame_times(300, 60.0)),
                                  np.asarray(times))
    cases = [
        (janim.default_sway(), tanim.default_sway()),
        (janim.default_sway(3.0), tanim.default_sway(3.0)),
        (janim.RotateXYBounce(0.3, speed=0.7, offset=0.1),
         tanim.RotateXYBounce(0.3, speed=0.7, offset=0.1)),
        (janim.Translate(0.5, axis=jt.Axis.Z, speed=2.0, offset=0.3),
         tanim.Translate(0.5, axis=tt.Axis.Z, speed=2.0, offset=0.3)),
        (janim.Animation(), tanim.Animation()),
    ]
    for ja, ta in cases:
        want = np.asarray(ja.batch(times))
        got = _np(ta.batch(_np(times)))
        # sin/cos rounding (1 ulp each), carried through 4x4 products.
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_camera_and_scene_match_jax(checker_texture):
    for size, fov in [((640, 480), 18.0), ((1920, 1080), 18.0),
                      ((128, 96), 60.0)]:
        np.testing.assert_array_equal(
            _np(tdr.Camera(size, fov_y=fov).projection),
            jdr.Camera(size, fov_y=fov).projection)
    tex_j = jdr.Texture(checker_texture[..., :3])
    tex_t = tdr.Texture(checker_texture[..., :3])
    np.testing.assert_array_equal(_np(tex_t.image), tex_j.image)
    depth = np.random.default_rng(5).integers(0, 256, (48, 64), np.uint8)
    mj = jdr.Mesh.from_texture(tex_j, depth_map=depth, density=4)
    mt = tdr.Mesh.from_texture(tex_t, depth_map=depth, density=4)
    np.testing.assert_array_equal(_np(mt.vertices), mj.vertices)
    np.testing.assert_array_equal(_np(mt.texture_coordinates),
                                  mj.texture_coordinates)
    assert mt.num_triangles == mj.num_triangles and mt.is_grid
    flat = tdr.Mesh.from_texture(tex_t, density=2)
    assert torch.all(flat.vertices[:, 2] == 1.0)


def test_convert_round_trip(checker_texture):
    depth = np.random.default_rng(7).integers(0, 256, (24, 32), np.uint8)
    mj = jdr.Mesh.from_texture(jdr.Texture(checker_texture), depth_map=depth,
                               density=3)
    mj.transform = np.asarray(jt.translation(0.1, 0.2, 0.3))
    n = 9
    mesh = convert.scene_from_numpy(mj.vertices.reshape(n, n, 3),
                                    mj.texture_coordinates.reshape(n, n, 2),
                                    checker_texture, mj.transform)
    np.testing.assert_array_equal(_np(mesh.vertices), mj.vertices)
    np.testing.assert_array_equal(_np(mesh.texture_coordinates),
                                  mj.texture_coordinates)
    np.testing.assert_array_equal(_np(mesh.indices).astype(np.int64),
                                  mj.indices.astype(np.int64))
    np.testing.assert_array_equal(_np(mesh.transform), mj.transform)
    assert mesh.grid_density == 3
    for args in [(9, 64, 48), (129, 256, 144), (1025, 1920, 1080),
                 (2049, 1920, 1080), (129, 128, 96)]:
        jcfg = jrs.suggest_scan_config(*args)
        tcfg = convert.scan_config_from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError):
        convert.scene_from_numpy(np.zeros((10, 3)), np.zeros((10, 2)),
                                 checker_texture)


@pytest.mark.parametrize("grid_n,width,height,kw", [
    (9, 64, 48, {}), (129, 128, 96, {}), (257, 320, 240, {}),
    (513, 1280, 720, {}), (1025, 1920, 1080, {}),
    (1025, 1920, 1080, {"colfix": None}), (1025, 3840, 2160, {}),
    (2049, 1920, 1080, {}), (4097, 3840, 2160, {}),
    (1025, 1920, 1080, {"quality": True}), (33, 128, 96, {"hyps": 1}),
    (1025, 1920, 1080, {"patch": True}),
    (1025, 1920, 1080, {"quality": True, "colfix": 2}),
    (4097, 3840, 2160, {"edge_cull_threshold": 0.25}),
    (2049, 1920, 1080, {"quality": True}),
    (4097, 3840, 2160, {"patch": True, "colfix": 3}),
])
def test_suggest_scan_config_equals_jax(grid_n, width, height, kw):
    j = jrs.suggest_scan_config(grid_n, width, height, **dict(kw))
    t = trs.suggest_scan_config(grid_n, width, height, **dict(kw))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_scan_supported_is_standard_variant():
    """The standard variant through d10 and big_grid through d12 (BASELINE
    preset 4 at 4K) are inside the JAX package's budget; d13 is not, and
    takes the tiled Pallas route, as the JAX package's ``_auto_impl`` picks
    it on its accelerator."""
    for n, size in [(1025, (1920, 1080)), (257, (320, 240)),
                    (2049, (1920, 1080)), (4097, (3840, 2160)),
                    (8193, (3840, 2160))]:
        t = trs.suggest_scan_config(n, *size)
        j = jrs.suggest_scan_config(n, *size)
        assert trs.scan_supported(n, t) == jrs.scan_supported(n, j)
        assert t.big_grid == (n > 1025)
        assert trs.scan_supported(n, t) == (n <= 4097)
        assert trender._auto_impl(n, *size) == ("scan" if n <= 4097
                                                else "pallas")
    assert trs.scan_supported(1025) and trs.scan_supported(2049)
    with pytest.raises(NotImplementedError):
        trs.check_supported(trs.ScanConfig(mxu_march=True, hyps=1))
    for ported in [dict(row_edge=True, dual_col=True), dict(patch=True),
                   dict(colfix=0), dict(colfix=2), dict(colfix=3),
                   dict(big_grid=True, pack_xy=False),
                   dict(edge_cull_threshold=0.5)]:
        trs.check_supported(trs.ScanConfig(**ported))


def test_pack_texture_and_unpack_match_jax(checker_texture):
    tex = checker_texture.astype(np.float32)
    tex[3, 5] = [254.6, 0.4, 128.5, 127.5]   # rounding of non-integer texels
    got = _np(trs.pack_texture(torch.from_numpy(tex)))
    want = np.asarray(jrs._pack_texture(tex, 48, 64))
    np.testing.assert_array_equal(got.view(np.uint32), want)
    raw = np.random.default_rng(1).integers(-2**31, 2**31, (2, 16, 128),
                                            dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        trs.unpack_raw_frames(torch.from_numpy(raw), 100, 13),
        jrs.unpack_raw_frames(raw.view(np.uint32), 100, 13))


def test_common_sampler_and_shade_match_jax(checker_texture):
    from depthrenderer_tpu.ops import common as jcommon

    rng = np.random.default_rng(11)
    u = rng.uniform(-0.1, 1.1, (40, 30)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (40, 30)).astype(np.float32)
    zm = rng.uniform(-0.5, 1.5, (40, 30)).astype(np.float32)
    cov = rng.uniform(size=(40, 30)) < 0.8
    tex = checker_texture.astype(np.float32)
    np.testing.assert_array_equal(
        _np(tcommon.sample_texture_bilinear(torch.from_numpy(tex),
                                            torch.from_numpy(u),
                                            torch.from_numpy(v))),
        np.asarray(jcommon.sample_texture_bilinear(tex, u, v)))
    for mode in ("texture", "debug_z"):
        np.testing.assert_array_equal(
            _np(tcommon.shade(torch.from_numpy(cov), torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(zm),
                              torch.from_numpy(tex), mode)),
            np.asarray(jcommon.shade(cov, u, v, zm, tex, mode)))


def test_fma_rounds_once():
    # Round-to-odd emulation of a fused multiply-add: exact against rational
    # arithmetic on cancellation-heavy inputs.
    from fractions import Fraction

    rng = np.random.default_rng(2)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32)
    c[::3] = rng.standard_normal(1000).astype(np.float32)
    got = _np(tcommon.fma(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)))
    for i in range(0, 3000, 5):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = np.float32(got[i])
        err = abs(Fraction(float(f)) - exact)
        for nb in (np.nextafter(f, np.float32(np.inf)),
                   np.nextafter(f, np.float32(-np.inf))):
            assert abs(Fraction(float(nb)) - exact) >= err


def _png_pair(tmp_path, h=36, w=52):
    from PIL import Image

    rng = np.random.default_rng(4)
    colour = rng.integers(0, 256, (h, w, 3), np.uint8)
    depth16 = (rng.integers(0, 4000, (h // 2, w // 2))).astype(np.uint16)
    cp, dp = tmp_path / "c.png", tmp_path / "d.png"
    Image.fromarray(colour).save(cp)
    Image.fromarray(depth16).save(dp)
    return cp, dp


def test_io_matches_jax(tmp_path):
    cp, dp = _png_pair(tmp_path)
    np.testing.assert_array_equal(tio.load_colour(cp), jio.load_colour(cp))
    np.testing.assert_array_equal(tio.load_colour(cp, should_mask=True),
                                  jio.load_colour(cp, should_mask=True))
    dj, dt = jio.load_depth(dp), tio.load_depth(dp)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(tio.resize(dt, (36, 52)),
                                  jio.resize(dj, (36, 52)))
    np.testing.assert_array_equal(tio.to_uint8(np.array([0.0, 0.5, 1.2])),
                                  jio.to_uint8(np.array([0.0, 0.5, 1.2])))


def test_png_avi_and_writers(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (3, 30, 42, 4), np.uint8)
    tio.save_image(frames[0], tmp_path / "f.png")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "f.png")),
                                  frames[0])
    with tvideo.AviFile(tmp_path / "dib.avi", (42, 30), fps=24,
                        codec="DIB ") as avi:
        for f in frames:
            avi.write(f)
    dec = jvideo.read_avi_frames(tmp_path / "dib.avi")
    np.testing.assert_array_equal(np.stack(dec), frames[..., :3])
    assert jvideo.read_avi_info(tmp_path / "dib.avi")[:3] == (42, 30, 3)
    # MJPG through the async writer: decodes, right count and size.
    vw = twriters.AsyncVideoWriter(tmp_path / "m.avi", (42, 30), fps=30)
    iw = twriters.AsyncImageWriter(num_workers=2)
    for k, f in enumerate(frames):
        vw.write(f)
        iw.write(f, tmp_path / f"{k}.png")
    vw.cleanup()
    iw.cleanup()
    dec = jvideo.read_avi_frames(tmp_path / "m.avi")
    assert len(dec) == 3 and dec[0].shape == (30, 42, 3)
    smooth = np.tile(np.linspace(0, 255, 42, dtype=np.uint8)[None, :, None],
                     (30, 1, 3))
    jpeg = np.asarray(Image.open(__import__("io").BytesIO(
        tvideo.encode_jpeg(smooth))))
    assert np.abs(jpeg.astype(int) - smooth).mean() < 3.0
    assert native.jpeg_encode(smooth)[:2] == b"\xff\xd8"
    for k in range(3):
        assert (tmp_path / f"{k}.png").stat().st_size > 0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import depthrenderer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'depthrenderer_tpu' or "
        "k.startswith('depthrenderer_tpu.'))\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("[]")


def test_render_clip_cuda_raises_without_a_card(checker_texture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU box")
    mesh = tdr.Mesh.from_texture(tdr.Texture(checker_texture), density=2)
    views = torch.eye(4)[None]
    with pytest.raises(RuntimeError, match="cuda"):
        trender.render_clip(mesh, tdr.Camera((64, 48)).projection, views,
                            64, 48)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["c.png", "d.png"])


@pytest.mark.parametrize("flags", [
    ["--container", "mp4"], ["--overlay-noise", "32", "16"],
    ["--quality", "--mode", "wireframe"],
])
def test_unported_cli_options_raise(flags, tmp_path, monkeypatch):
    """The three JAX-CLI options the port once refused now render: the MP4
    (remuxed: no ffmpeg here), the noised depth and the quality tier's
    wireframe."""
    monkeypatch.setattr(tvideo.shutil, "which", lambda name: None)
    cp, dp = _png_pair(tmp_path)
    out = tmp_path / "out"
    assert tcli.main([str(cp), str(dp), "--device", "cpu", "-mesh-density",
                      "4", "--width", "64", "--height", "48", "--frames",
                      "2", "-output-path", str(out)] + flags) == 0
    ext = "mp4" if "mp4" in flags else "avi"
    video = out / f"{cp.name}.{ext}"
    assert tvideo.read_video_info(video)[:3] == (64, 48, 2)
    frames = np.stack(tvideo.read_video_frames(video))
    assert (frames.max(axis=-1) > 0).mean() > 0.1
    assert not any(out.glob("*.tmp.avi"))


@pytest.mark.parametrize("flags", [
    ["--quality"], ["--patch"], ["--colfix", "0"], ["--colfix", "2"],
    ["--colfix", "3"], ["--mode", "wireframe"], ["--edge-cull", "2.0"],
    ["--impl", "scan", "--edge-cull", "2.0", "--mode", "debug_z"],
])
def test_fidelity_cli_options_render(flags, tmp_path):
    cp, dp = _png_pair(tmp_path)
    out = tmp_path / "out"
    assert tcli.main([str(cp), str(dp), "--device", "cpu", "-mesh-density",
                      "5", "--width", "128", "--height", "96", "--frames",
                      "2", "--codec", "DIB ", "-output-path", str(out)]
                     + flags) == 0
    assert (out / "sample_frame.png").stat().st_size > 0
    frames = np.stack(jvideo.read_avi_frames(out / f"{cp.name}.avi"))
    assert frames.shape == (2, 96, 128, 3)
    assert (frames.max(axis=-1) > 0).mean() > 0.3


@pytest.mark.parametrize("mode", ["texture", "texture_z"])
def test_march_writes_raster_z_only_for_its_readers(checker_texture, mode):
    """The single pass's attrs are 4 planes; the raster-z plane comes only
    where a reader asks for it (the texture_z shade, the attrs merge)."""
    mesh = tdr.Mesh.from_texture(tdr.Texture(checker_texture), density=4)
    n, w, h = 17, 64, 48
    cfg = trs.suggest_scan_config(n, w, h)
    g = trs.ScanGeometry.of(w, h, n, n, cfg)
    mvps = tt.matmul(tt.perspective(18.0, w / h),
                     tt.translation(dz=-10.0))[None]
    prep = trs.prep_scan(mvps, mesh.vertices.reshape(n, n, 3), w, h, cfg)
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    margs = args + (prep.canch[0], prep.mid[0], trs.minv_rows(mvps)[0], g,
                    cfg)
    rec = trs.solve_records(*args, g, cfg)
    raster_z = mode == "texture_z"
    attrs = trs.march_exact(rec, *margs, raster_z=raster_z)
    full = trs.march_exact(rec, *margs, raster_z=True)
    assert attrs.shape == (trs.n_attrs(raster_z), g.hpad, g.wl)
    assert torch.equal(attrs, full[:attrs.shape[0]])
    cov = full[3] > 0.5
    assert cov.float().mean() > 0.3
    assert bool((full[4][~cov] == np.float32(3.0e38)).all())
    texq = trs.pack_texture(mesh.texture.image)
    out = trs.shade(attrs, texq, g, cfg, mode)
    if raster_z:
        packed, z = out
        assert torch.equal(z[cov], full[4][cov])
    else:
        packed = out
    assert torch.equal(packed, trs.shade(full, texq, g, cfg, "texture_z")[0])
    with pytest.raises(ValueError, match="5 planes"):
        trs.shade(full[:4], texq, g, cfg, "texture_z")


def test_quality_and_patch_are_exclusive(checker_texture):
    args = tcli.build_parser().parse_args(
        ["c.png", "d.png", "--device", "cpu", "-mesh-density", "2",
         "--width", "64", "--height", "48", "--frames", "1", "--quality",
         "--patch", "--no-video"])
    with pytest.raises(ValueError, match="exclusive"):
        tcli.render_scene(checker_texture, np.zeros((48, 64), np.uint8), args)


def test_big_grid_density_raises(checker_texture, monkeypatch):
    """Past big_grid's budget (d13) the CLI no longer raises before it
    meshes the grid: it goes on to mesh it (stopped here, before a 8193 x
    8193 grid is built) and ``render_clip`` takes the tiled route."""

    class Meshed(Exception):
        pass

    def stop(*args, density=None, **kwargs):
        raise Meshed(density)

    monkeypatch.setattr(tcli.Mesh, "from_texture", stop)
    for impl in ("auto", "scan"):
        args = tcli.build_parser().parse_args(
            ["c.png", "d.png", "--device", "cpu", "-mesh-density", "13",
             "--impl", impl])
        with pytest.raises(Meshed) as info:
            tcli.render_scene(checker_texture, np.zeros((48, 64), np.uint8),
                              args)
        assert info.value.args == (13,)
    assert trender._auto_impl(8193, 1920, 1080) == "pallas"


@pytest.mark.parametrize("impl", ["auto", "scan"])
def test_past_the_scan_budget_falls_back_to_the_tiled_route(
        checker_texture, monkeypatch, capsys, impl):
    """With the scan's budget test false (as at d13), ``render_clip`` logs
    the reference's NOTICE and renders the clip through the tiled Pallas
    route: frames equal ``impl="pallas"``'s, on the CPU."""
    mesh = tdr.Mesh.from_texture(tdr.Texture(checker_texture),
                                 depth_map=checker_texture[..., 0],
                                 density=4)
    camera = tdr.Camera((64, 48), fov_y=18.0)
    views = tt.matmul(tt.translation(dz=-10.0)[None],
                      tanim.default_sway(5.0).batch(
                          tanim.frame_times(3, 60.0)))
    tiled = trender.render_clip(mesh, camera.projection, views, 64, 48,
                                device="cpu", impl="pallas")
    capsys.readouterr()
    monkeypatch.setattr(trs, "scan_supported", lambda *a, **k: False)
    got = trender.render_clip(mesh, camera.projection, views, 64, 48,
                              device="cpu", impl=impl,
                              config=trs.suggest_scan_config(17, 64, 48))
    out = capsys.readouterr().out
    assert "NOTICE: grid n=17 exceeds the scan kernel's VMEM window " in out
    assert "falling back to the tiled path" in out
    assert got.shape == (3, 48, 64, 4) and (got[..., :3] > 0).any()
    np.testing.assert_array_equal(got, tiled)


def test_cli_parser_keeps_the_jax_flags():
    from depthrenderer_tpu import cli as jcli

    def dests(parser):
        return {a.dest for a in parser._actions if a.dest != "help"}

    assert dests(jcli.build_parser()) <= dests(tcli.build_parser())
    assert "device" in dests(tcli.build_parser())
    assert tcli.build_parser().parse_args(["a", "b"]).device == "cuda"


def test_edge_cull_model_z_matches_jitted_jax():
    """The edge cull's corner model z (``_model_z``) bit for bit against the
    JAX kernel's ``zm_of`` expression as XLA's CPU backend compiles it under
    ``jit`` (the matrix rows passed as arguments, as the kernel reads
    them)."""
    import jax
    import jax.numpy as jnp

    width, height = 1920, 1080

    def zm_of(x, y, z, m2r, m3r):   # raster_scan.py: invw_of, zm_of
        sxw, syw = 2.0 / width, 2.0 / height
        iw = (m3r[0] * (x * sxw - 1.0) + m3r[1] * (y * syw - 1.0)
              + m3r[2] * z + m3r[3])
        num = (m2r[0] * (x * sxw - 1.0) + m2r[1] * (y * syw - 1.0)
               + m2r[2] * z + m2r[3])
        return num / jnp.where(jnp.abs(iw) > 1e-30, iw, 1.0)

    rng = np.random.default_rng(12)
    x = rng.uniform(-200, 2200, 20000).astype(np.float32)
    y = rng.uniform(-200, 1300, 20000).astype(np.float32)
    z = rng.uniform(-1, 1, 20000).astype(np.float32)
    m = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jax.jit(zm_of)(x, y, z, m[:4], m[4:]))
    c = trs._Consts.of(trs.ScanGeometry.of(width, height, 9, 9,
                                           trs.ScanConfig()))
    t = [torch.tensor(v) for v in m]
    got = trs._model_z(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(z), t[:4], t[4:],
                       torch.tensor(c.sxw), torch.tensor(c.syw))
    np.testing.assert_array_equal(_np(got), want)
