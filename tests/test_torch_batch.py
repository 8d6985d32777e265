"""The batch farm and its pieces against the JAX package's, on the CPU.

Bars, with their reasons:

* Tasks, ``flatten_arrays``, ``interweave_arrays`` and the evaluation's
  mask are exact; ``perlin`` is host numpy float64 in both packages (the
  seed's permutation is numpy's), within 1e-12, and the overlaid uint8
  depth maps are equal. The PSNRs are float64 sums, equal to 1e-9 dB.
* ``render_scenes_sharded`` on the grid route, over three CPU devices and
  over one: equal to each other byte for byte (each scene renders through
  the one-scene function, whatever the device count), and against JAX's
  one-device ``_render_scenes_host`` at the tiled routes' frame bar (PSNR
  >= 60 dB, <= 0.2 % of pixels off by more than 1 LSB; the JAX tests' own
  cross-route bar).
* ``batch.main`` (3 models, one ``ground_truth``, d5, 64x48, 4 frames):
  the sequential and the ``--sharded --readback rgba`` runs write the same
  bytes (the same per-model config, the same render function); every
  ``--readback yuv420`` frame is the native YUV encode of the port's YUV
  pack of the frame the sequential run renders, byte for byte; the
  post-processing outputs decode equal to JAX's ``postprocess`` run on the
  same videos (both with the native JPEG encoder).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from depthrenderer_tpu import cli as jcli
from depthrenderer_tpu import evaluate as jevaluate
from depthrenderer_tpu import meshgen as jmeshgen
from depthrenderer_tpu import postprocess as jpost
from depthrenderer_tpu import tasks as jtasks
from depthrenderer_tpu import transforms as jtransforms
from depthrenderer_tpu import utils as jutils
from depthrenderer_tpu.ops import common as jcommon
from depthrenderer_tpu.parallel import sharding as jsharding

from depthrenderer_tpu_torch import batch as tbatch
from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import evaluate as tevaluate
from depthrenderer_tpu_torch import io as tio
from depthrenderer_tpu_torch import native as tnative
from depthrenderer_tpu_torch import tasks as ttasks
from depthrenderer_tpu_torch import utils as tutils
from depthrenderer_tpu_torch import video as tvideo
from depthrenderer_tpu_torch.ops import raster_scan as trs
from depthrenderer_tpu_torch.parallel import (device_blocks,
                                              render_frames_sharded,
                                              render_scenes_sharded)
from depthrenderer_tpu_torch.render import render_clip
from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture
from test_torch_tiled import frame_bar, tcfg

torch.set_num_threads(1)

MODELS = ("ground_truth", "model_a", "model_b")
FRAMES = 4


# ---------------------------------------------------------------------------
# Tasks, array packing, noise and evaluation
# ---------------------------------------------------------------------------

def call_log(mod, kind, calls=7, **kw):
    """Which calls of a wrapped recorder ran, and what each call returned,
    with one reset after the fourth call."""
    ran = []
    task = getattr(mod, kind)(lambda k: ran.append(k) or k * 10, **kw)
    out = []
    for k in range(calls):
        if k == 4:
            task.reset()
        out.append(task(k))
    return ran, out, task.call_count


@pytest.mark.parametrize("kind,kw", [
    ("Task", {}), ("DelayedTask", {"delay": 2}), ("OneTimeTask", {}),
    ("RecurringTask", {"frequency": 3})])
def test_tasks_follow_jax_call_sequences(kind, kw):
    assert call_log(ttasks, kind, **kw) == call_log(jtasks, kind, **kw)


def test_recurring_task_rejects_a_zero_frequency():
    with pytest.raises(ValueError):
        ttasks.RecurringTask(lambda: None, frequency=0)


def test_array_packing_equals_jax():
    arrays = [np.arange(6).reshape(2, 3), np.arange(6, 12).reshape(3, 2)]
    for a, b in zip(tutils.flatten_arrays(arrays),
                    jutils.flatten_arrays(arrays)):
        np.testing.assert_array_equal(a, b)
    flat = [np.arange(k, k + 5) for k in (0, 10, 20)]
    np.testing.assert_array_equal(tutils.interweave_arrays(flat),
                                  jutils.interweave_arrays(flat))


@pytest.mark.parametrize("scale,seed", [(5, None), (32, 0), (8, 3)])
def test_perlin_and_overlay_equal_jax(scale, seed):
    a = tutils.perlin(64, 48, scale=scale, seed=seed)
    if seed is None:   # an unseeded permutation differs call to call
        assert a.shape == (48, 64)
        return
    b = jutils.perlin(64, 48, scale=scale, seed=seed)
    assert np.abs(a - b).max() <= 1e-12
    img = np.random.default_rng(seed).integers(0, 256, (48, 64, 1),
                                               dtype=np.uint8)
    np.testing.assert_array_equal(
        tutils.overlay_noise(img, scale=scale, seed=seed),
        jutils.overlay_noise(img, scale=scale, seed=seed))


def test_cli_overlay_noise_depth_equals_jax():
    """The CLI's ``--overlay-noise 32 16 8`` depth against the JAX CLI's own
    loop (``cli.py:147-153``), byte for byte."""
    depth = np.random.default_rng(4).integers(0, 256, (48, 64),
                                              dtype=np.uint8)
    d = depth[..., None]
    for scale in (32, 16, 8):
        d = jutils.overlay_noise(d, scale=scale, seed=0)
    np.testing.assert_array_equal(tcli.noised_depth(depth, [32, 16, 8]),
                                  d[..., 0])
    assert jcli.build_parser().parse_args(
        ["c", "d", "--overlay-noise", "32", "16", "8"]).overlay_noise == \
        tcli.build_parser().parse_args(
            ["c", "d", "--overlay-noise", "32", "16", "8"]).overlay_noise


def test_evaluation_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    depth = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    depth[:, :12] = 40
    for thr, dil in [(16, 3), (40, 1), (16, 0)]:
        np.testing.assert_array_equal(
            tevaluate.discontinuity_mask(depth, thr, dil).numpy(),
            jevaluate.discontinuity_mask(depth, thr, dil))
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-4, 5, a.shape), 0,
                255).astype(np.uint8)
    for d in (None, depth, depth[..., None]):
        assert abs(tevaluate.masked_psnr(a, b, d)
                   - jevaluate.masked_psnr(a, b, d)) <= 1e-9
    assert tevaluate.masked_psnr(a, a, depth) == float("inf")
    assert np.isnan(tevaluate.masked_psnr(a, b, depth, threshold=0,
                                          dilate=40))
    paths = []
    for k, img in enumerate((a, b)):
        path = tmp_path / f"v{k}.avi"
        with tvideo.AviFile(path, (64, 48), codec="DIB ") as f:
            f.write(img)
            f.write(img[::-1].copy())
        paths.append(path)
    got = tevaluate.compare_videos(*paths, depth)
    want = jevaluate.compare_videos(*paths, depth)
    assert len(got) == len(want) == 2
    assert np.abs(np.array(got) - np.array(want)).max() <= 1e-9
    assert tevaluate.main([str(p) for p in paths] + ["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# render_scenes_sharded and render_frames_sharded
# ---------------------------------------------------------------------------

def sharded_inputs():
    """Three d5 scenes (seeded smooth relief), two views each, a checker
    texture."""
    W, H, n = 64, 48, 33
    yy, xx = np.mgrid[0:48, 0:64]
    tex = np.stack([xx * 4, yy * 5, ((xx // 8 + yy // 8) % 2) * 255,
                    np.full((48, 64), 255)], axis=-1).astype(np.uint8)
    base = (np.asarray(jtransforms.perspective(18.0, W / H))
            @ np.asarray(jtransforms.translation(dz=-10.0)))
    yaw = np.asarray(jtransforms.rotation(0.06, axis=jtransforms.Axis.Y))
    mvps = np.stack([np.stack([base, base @ yaw])] * 3).astype(np.float32)
    vgs, uvs = [], []
    for seed in (1, 2, 3):
        depth = 120 + 90 * np.sin(xx / 64 * (5 + seed) + seed) * np.cos(
            yy / 48 * 4)
        depth[10:20, 8 * seed:8 * seed + 12] = 250
        v, uv, _ = (np.asarray(a) for a in jmeshgen.grid_mesh(
            np.clip(depth, 0, 255).astype(np.uint8), 5))
        v = v.copy()
        v[:, 2] *= 4.0
        vgs.append(v.reshape(n, n, 3).astype(np.float32))
        uvs.append(uv.reshape(n, n, 2).astype(np.float32))
    cfg = jcommon.suggest_config(n, W, H, tile_w=32)
    return W, H, mvps, vgs, uvs, tex, cfg


def test_render_scenes_sharded_equal_over_device_counts_and_to_jax():
    W, H, mvps, vgs, uvs, tex, cfg = sharded_inputs()
    args = (torch.from_numpy(mvps), [torch.from_numpy(v) for v in vgs],
            [torch.from_numpy(u) for u in uvs],
            [torch.from_numpy(tex)] * 3, W, H, tcfg(cfg))
    three = render_scenes_sharded(*args, impl="grid", frame_batch=2,
                                  devices=["cpu", "cpu", "cpu"])
    one = render_scenes_sharded(*args, impl="grid", frame_batch=2,
                                devices=["cpu"])
    assert len(three) == len(one) == 3
    for a, b in zip(three, one):
        assert torch.equal(a, b)
    want = np.asarray(jsharding._render_scenes_host(
        jnp.asarray(mvps), jnp.asarray(np.stack(vgs)),
        jnp.asarray(np.stack(uvs)),
        jnp.asarray(np.stack([tex] * 3), jnp.float32), W, H, cfg, "texture",
        2, "grid", None))
    for s in range(3):
        frame_bar(three[s].numpy(), want[s])
    assert device_blocks(3, 2) == [(0, 2), (2, 3)]
    assert device_blocks(4, 3) == [(0, 2), (2, 4), (4, 4)]


def test_render_frames_sharded_equals_one_device():
    W, H, mvps, vgs, uvs, tex, cfg = sharded_inputs()
    views = torch.from_numpy(np.concatenate([mvps[0], mvps[1][:1]]))
    args = (views, torch.from_numpy(vgs[0]), torch.from_numpy(uvs[0]),
            torch.from_numpy(tex), W, H, tcfg(cfg))
    blocks, stats = render_frames_sharded(*args, devices=["cpu"] * 4,
                                          frame_batch=2, with_stats=True)
    assert [b.shape[0] for b in blocks] == [1, 1, 1]   # the 4th is empty
    whole = render_frames_sharded(*args, devices=["cpu"], frame_batch=3)[0]
    assert torch.equal(torch.cat(blocks), whole)
    luma = (whole[..., :3].double()
            @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float64))
    assert abs(stats["mean_luma"] - float(luma.mean())) <= 1e-9


def test_sharded_scan_checks_uv_grids_once_and_takes_none(monkeypatch):
    """The scan checks each given UV grid once a call (the farm checks its
    host grids once and passes None, since a check of a grid on a card
    waits for the card); frames with None equal frames with the grids, a
    bent grid is refused, and the tiled routes refuse None."""
    W, H, mvps, vgs, uvs, tex, cfg = sharded_inputs()
    checked = []
    check = trs.check_uv_grid
    monkeypatch.setattr(trs, "check_uv_grid", lambda uv: (
        checked.append(uv is not None), check(uv))[1])
    args = (torch.from_numpy(mvps[:2, :1]),
            [torch.from_numpy(v) for v in vgs[:2]])
    rest = ([torch.from_numpy(tex)] * 2, W, H)
    given = render_scenes_sharded(*args, [torch.from_numpy(u)
                                          for u in uvs[:2]], *rest,
                                  devices=["cpu", "cpu"])
    assert sum(checked) == 2
    none = render_scenes_sharded(*args, None, *rest, devices=["cpu"])
    assert sum(checked) == 2
    for a, b in zip(given, none):
        assert torch.equal(a, b)
    blocks = render_frames_sharded(
        torch.from_numpy(mvps[0]), torch.from_numpy(vgs[0]),
        torch.from_numpy(uvs[0]), torch.from_numpy(tex), W, H, impl="scan",
        devices=["cpu", "cpu"])
    assert sum(checked) == 3 and torch.equal(torch.cat(blocks)[:1], given[0])
    bent = torch.from_numpy(uvs[0][::-1].copy())
    with pytest.raises(ValueError, match="UV parameterisation"):
        render_scenes_sharded(args[0][:1], args[1][:1], [bent],
                              rest[0][:1], W, H, devices=["cpu"])
    with pytest.raises(ValueError, match="needs the UV grids"):
        render_scenes_sharded(*args, None, *rest, tcfg(cfg), impl="grid",
                              devices=["cpu"])


def test_render_clip_checks_the_uv_grid_once(monkeypatch):
    """``render_clip`` checks the mesh's UV grid once, on the host, before
    the upload, not once a frame group; a bent grid is refused."""
    yy, xx = np.mgrid[0:48, 0:64]
    colour = np.stack([xx * 4, yy * 5, (xx + yy) % 256],
                      axis=-1).astype(np.uint8)
    depth = (120 + 90 * np.sin(xx / 10.0)).astype(np.uint8)
    mesh = Mesh.from_texture(Texture(colour), depth, density=4)
    proj = Camera((64, 48), fov_y=18.0).projection
    views = tbatch.farm_views(60.0, 3)
    checked = []
    check = trs.check_uv_grid
    monkeypatch.setattr(trs, "check_uv_grid", lambda uv: (
        checked.append(uv is not None), check(uv))[1])
    frames = render_clip(mesh, proj, views, 64, 48, frame_batch=1,
                         device="cpu")
    assert frames.shape == (3, 48, 64, 4) and sum(checked) == 1
    mesh.texture_coordinates = mesh.texture_coordinates.flip(0)
    with pytest.raises(ValueError, match="UV parameterisation"):
        render_clip(mesh, proj, views, 64, 48, device="cpu")


# ---------------------------------------------------------------------------
# batch.main end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def farm_inputs(tmp_path_factory):
    """A 64x48 colour image and three models' depth maps of its name."""
    from PIL import Image

    root = tmp_path_factory.mktemp("farm")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:48, 0:64]
    colour = np.stack([xx * 255 // 63, yy * 255 // 47,
                       ((xx // 8 + yy // 8) % 2) * 200 + 27], axis=-1)
    colour = np.clip(colour + rng.normal(0, 6, colour.shape), 0, 255)
    Image.fromarray(colour.astype(np.uint8)).save(root / "scene.png")
    for k, model in enumerate(MODELS):
        depth = 120 + 90 * np.sin(xx / 64 * (6 + k) + 0.3) * np.cos(yy / 48 * 4)
        depth[6:12, 8:16 + 4 * k] = 245
        (root / "models" / model).mkdir(parents=True)
        Image.fromarray(np.clip(depth, 0, 255).astype(np.uint8)).save(
            root / "models" / model / "scene.png")
    return root


def farm_args(root, out, *extra):
    return [str(root / "scene.png"), str(root / "models"), "--device", "cpu",
            "-mesh-density", "5", "--frames", str(FRAMES), "-output-path",
            str(out), *extra]


@pytest.fixture(scope="module")
def farm_runs(farm_inputs, tmp_path_factory):
    """The sequential run (with post-processing) and the sharded rgba and
    yuv420 runs (without)."""
    out = tmp_path_factory.mktemp("farm_out")
    runs = {}
    for name, extra in [("seq", []),
                        ("rgba", ["--sharded", "--readback", "rgba",
                                  "--no-post"]),
                        ("yuv", ["--sharded", "--readback", "yuv420",
                                 "--no-post"])]:
        assert tbatch.main(farm_args(farm_inputs, out / name, *extra)) == 0
        runs[name] = out / name
    return runs


def videos(run):
    return {m: run / "single_videos" / "scene" / f"{m}.avi" for m in MODELS}


def model_frames(root, model):
    """The frames the farm renders for ``model``, through ``render_clip``
    on the farm's own camera path."""
    colour = tio.load_colour(root / "scene.png")
    depth = tio.resize(tio.load_depth(root / "models" / model / "scene.png"),
                       colour.shape)
    mesh = Mesh.from_texture(Texture(colour), depth, density=5)
    mesh.vertices[:, 2] *= 4.0
    from depthrenderer_tpu_torch import animation, transforms

    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway(5.0).batch(animation.frame_times(FRAMES,
                                                                60.0)))
    return render_clip(mesh, Camera((64, 48), fov_y=18.0).projection, views,
                       64, 48, device="cpu")


def test_farm_sequential_and_sharded_rgba_are_byte_identical(farm_runs):
    seq, rgba = videos(farm_runs["seq"]), videos(farm_runs["rgba"])
    for m in MODELS:
        assert seq[m].read_bytes() == rgba[m].read_bytes(), m
        assert tvideo.read_avi_info(seq[m])[:3] == (64, 48, FRAMES)
        # The PNG snapshot of frame 0 (one a second at 60 fps).
        for run in ("seq", "rgba", "yuv"):
            png = farm_runs[run] / "frames" / m / "000000.png"
            assert png.read_bytes() == \
                (farm_runs["seq"] / "frames" / m / "000000.png").read_bytes()


def test_farm_frames_are_render_clips(farm_inputs, farm_runs):
    """Each model's AVI holds ``render_clip``'s frames (native JPEG), and
    the YUV run's the native YUV encode of their YUV pack."""
    seq, yuv = videos(farm_runs["seq"]), videos(farm_runs["yuv"])
    for m in MODELS:
        frames = model_frames(farm_inputs, m)
        assert tvideo.read_avi_payloads(seq[m]) == \
            [tvideo.encode_jpeg(f[..., :3]) for f in frames]
        packed = tio.rgba_to_yuv420(torch.from_numpy(frames)).numpy()
        assert tvideo.read_avi_payloads(yuv[m]) == \
            [tnative.jpeg_encode_yuv420(*tio.yuv420_planes(p, 48, 64))
             for p in packed]
        got = tvideo.read_avi_frames(yuv[m])
        want = tvideo.read_avi_frames(seq[m])
        p = min(tutils.psnr(a, b) for a, b in zip(got, want))
        print(f"{m}: YUV readback against RGBA readback, decoded: "
              f"{p:.2f} dB")
        assert p >= 40.0


def test_farm_post_processing_equals_jax(farm_runs, tmp_path, monkeypatch):
    monkeypatch.setenv("DEPTHRENDERER_FORCE_NATIVE_JPEG", "1")
    monkeypatch.setattr(jpost, "ffmpeg_available", lambda: False)
    run = farm_runs["seq"]
    srcs = [str(v) for v in videos(run).values()]
    want = {
        "mosaic": jpost.create_mosaic_video(srcs, tmp_path / "mosaic",
                                            "scene", (48, 64), fps=60.0),
        "concat": jpost.create_concat_video(srcs, tmp_path / "concat",
                                            "scene")}
    for path in jpost.create_paired_videos(srcs, tmp_path / "paired",
                                           "scene", list(MODELS)):
        want[os.path.basename(path)] = path
    got = {"mosaic": run / "mosaic" / "scene.avi",
           "concat": run / "concat" / "scene.avi",
           **{f"ground_truth-{m}.avi": run / "paired" / "scene"
              / f"ground_truth-{m}.avi" for m in MODELS[1:]}}
    assert set(got) == set(want)
    counts = {"mosaic": FRAMES, "concat": 3 * FRAMES}
    for k in got:
        a, b = tvideo.read_video_frames(got[k]), tvideo.read_video_frames(
            want[k])
        assert len(a) == len(b) == counts.get(k, FRAMES), k
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert tvideo.read_avi_info(got["mosaic"])[:2] == (128, 96)


def test_farm_manifest_and_resume(farm_inputs, tmp_path):
    out = tmp_path / "resume"
    args = farm_args(farm_inputs, out, "--no-post")
    assert tbatch.main(args) == 0
    manifest = json.loads((out / "scene.manifest.json").read_text())
    assert sorted(manifest) == sorted(MODELS)
    assert all(v["frames"] == FRAMES for v in manifest.values())
    vids = videos(out)
    stamps = {m: vids[m].stat().st_mtime_ns for m in MODELS}
    os.remove(vids["model_a"])
    for extra in ([], ["--sharded"]):
        assert tbatch.main(args + ["--resume"] + extra) == 0
        assert vids["model_a"].exists()
        for m in ("ground_truth", "model_b"):   # finished: not rendered
            assert vids[m].stat().st_mtime_ns == stamps[m]
        os.remove(vids["model_a"])


@pytest.mark.parametrize("extra", [
    ["--impl", "pallas", "--quality"], ["--impl", "grid", "--patch"],
    ["--impl", "grid", "--colfix", "3", "--sharded"],
    ["--quality", "--patch"],
    ["--sharded", "--readback", "yuv420", "--codec", "DIB "]])
def test_farm_refuses_what_jax_refuses(farm_inputs, tmp_path, extra):
    with pytest.raises(SystemExit):
        tbatch.main(farm_args(farm_inputs, tmp_path / "x", *extra))


def test_farm_and_evaluate_need_a_card_without_device_cpu(farm_inputs,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU box")
    args = farm_args(farm_inputs, tmp_path / "c")
    args.remove("--device")
    args.remove("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tbatch.main(args)
    with pytest.raises(RuntimeError, match="cuda"):
        tevaluate.main(["a.avi", "b.avi"])
    assert tbatch.build_parser().parse_args(["a", "b"]).device == "cuda"


def test_farm_readback_choice():
    p = tbatch.build_parser()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    auto = p.parse_args(["a", "b"])
    assert tbatch._readback_yuv(auto, cuda, 640, 480)
    assert not tbatch._readback_yuv(auto, cpu, 640, 480)
    assert not tbatch._readback_yuv(auto, cuda, 641, 480)   # odd: rgba
    assert not tbatch._readback_yuv(p.parse_args(["a", "b", "--codec",
                                                  "DIB "]), cuda, 640, 480)
    assert tbatch._readback_yuv(p.parse_args(["a", "b", "--readback",
                                              "yuv420"]), cpu, 64, 48)
    assert trs.FRAME_GROUP == auto.frame_batch
