"""The batch farm (``batch.run_farm --sharded``) against the benchmark's
plain reference (``benchmark/reference/``: float64 mesh, camera, sway and
row oracle), on the CPU, with no JAX.

The set-up is the ``vga_d8.farm`` cell's in small: a seeded scene
(``benchmark/scenes.py``) at 96x72, its ground-truth depth map and one
noise overlay (the cell's driver writes both), mesh density 4, 24 frames a
model, a PNG snapshot every 8 frames, rendered sharded with the RGBA and
with the YUV 4:2:0 readback. Bars, with their reasons:

* The frames the RGBA run hands its writers, and its PNG snapshots,
  against the float64 oracle on seeded rows: at most ``OFF1_BAR`` (2 %)
  of the reference's covered pixels off by more than 1 LSB. The scan
  approximates by design (holes and wrong winners at depth edges; the
  CPU's plain passes are the card's kernels' twins), so the bar is not 0,
  though on this scene the CPU path reads 0; 2 % is about two pixels of
  each checked row, and a frame of the other model reads far above it.
  The benchmark's own check holds the card to its limit the same way.
* The YUV run's PNG snapshots are the RGBA run's, byte for byte: the
  snapshots take the same RGBA frames whatever the video's readback.
* The MVPs the farm renders with are the reference's frame by frame, to
  float32 rounding: the farm computes them in float32 and the reference in
  float64, and no entry exceeds 18, so 1e-5 is a few float32 ulps.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import avi, check, harness, scenes
from benchmark.reference import scene as ref_scene
from depthrenderer_tpu_torch import batch as tbatch
from depthrenderer_tpu_torch import writers as twriters

torch.set_num_threads(1)

FARM = harness.plugin(harness.BENCH, "drivers", "farm")
CONFIG = harness.load_json(harness.BENCH / "configs" / "vga_d8.json")
CONFIG.update(width=96, height=72, texture_width=96, texture_height=72,
              mesh_density=4)
MAPS = [{"name": "ground_truth"}, {"name": "noise_8", "scale": 8, "seed": 3}]
MODELS = sorted(m["name"] for m in MAPS)
FRAMES, EVERY, SEED = 24, 8, 2**31 + 77
ROWS = 12
OFF1_BAR = 0.02


def write_farm_inputs(root: Path, config=CONFIG, maps=MAPS, seed=SEED):
    """One seeded scene and its depth maps as the farm reads them ->
    (colour path, depth-maps folder, colour, {model: depth})."""
    colour, depth = scenes.make_scene(seed, 0, config["height"],
                                      config["width"])
    root.mkdir(parents=True, exist_ok=True)
    FARM.write_png(colour, root / "scene.png")
    written = {}
    for m, d in zip(maps, FARM.depth_maps(depth, maps)):
        (root / "models" / m["name"]).mkdir(parents=True)
        FARM.write_png(d, root / "models" / m["name"] / "scene.png")
        written[m["name"]] = d
    return root / "scene.png", root / "models", colour, written


def farm_argv(image, models, out, *extra, config=CONFIG, frames=FRAMES,
              every=EVERY):
    return [str(image), str(models), "--device", "cpu",
            "--width", str(config["width"]), "--height", str(config["height"]),
            "-mesh-density", str(config["mesh_density"]),
            "-displacement-factor", str(config["displacement_factor"]),
            "-fps", str(config["fps"]), "--fov-y", str(config["fov_y"]),
            "--frames", str(frames),
            "--png-every-seconds", repr(every / config["fps"]),
            "--sharded", "--no-post", "-output-path", str(out), *extra]


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """The sharded RGBA and YUV runs of one job: the frames the RGBA run
    handed each writer, the MVPs each chunk rendered, and the outputs."""
    root = tmp_path_factory.mktemp("farm_ref")
    image, models, colour, depths = write_farm_inputs(root / "in")
    handed, mvps = {}, {}
    write = twriters.AsyncVideoWriter.write
    sharded = tbatch.render_scenes_sharded

    def keep_write(self, frame):
        handed.setdefault(Path(self.path).stem, []).append(np.array(frame))
        return write(self, frame)

    def keep_mvps(m, *args, **kwargs):
        mvps.setdefault(readback, []).append(np.array(m))
        return sharded(m, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twriters.AsyncVideoWriter, "write", keep_write)
        mp.setattr(tbatch, "render_scenes_sharded", keep_mvps)
        for readback in ("rgba", "yuv420"):
            tbatch.run_farm(tbatch.build_parser().parse_args(farm_argv(
                image, models, root / readback, "--readback", readback)))
    yield {"colour": colour, "depths": depths, "handed": handed,
           "mvps": {r: np.concatenate(m, axis=1) for r, m in mvps.items()},
           "out": root}
    shutil.rmtree(root, ignore_errors=True)


def snapshot(run_dir, model, k):
    return run_dir / "frames" / model / f"{k:06d}.png"


def test_farm_frames_and_snapshots_match_the_float64_reference(farm):
    flat = [(farm["colour"], farm["depths"][m]) for m in MODELS]
    ref = check.Reference(CONFIG, flat, "cpu")
    shares = []
    for s, model in enumerate(MODELS):
        frames = farm["handed"][model]
        assert len(frames) == FRAMES
        rng = check.clip_rng(SEED, s)
        for k in (0, int(rng.integers(1, FRAMES)), FRAMES - 1):
            rows = check.pick_rows(rng, CONFIG["height"], ROWS)
            want = ref.rows(s, k, rows)
            shares.append(check.off1_share(frames[k][rows], want))
            if k % EVERY == 0:
                png = avi.read_png(snapshot(farm["out"] / "rgba", model, k))
                np.testing.assert_array_equal(png, frames[k])
        # A frame of the other model is far off: the bar tells them apart.
        other = ref.rows(1 - s, FRAMES - 1, rows)
        assert check.off1_share(frames[FRAMES - 1][rows], other) > 4 * OFF1_BAR
    print(f"off1 shares: {[round(x, 4) for x in shares]}")
    assert max(shares) <= OFF1_BAR


def test_yuv_snapshots_are_the_rgba_runs_byte_for_byte(farm):
    for model in MODELS:
        for k in range(0, FRAMES, EVERY):
            yuv = snapshot(farm["out"] / "yuv420", model, k)
            rgba = snapshot(farm["out"] / "rgba", model, k)
            assert yuv.read_bytes() == rgba.read_bytes(), (model, k)
            np.testing.assert_array_equal(avi.read_png(yuv),
                                          farm["handed"][model][k])
        pngs = sorted(p.name for p in (farm["out"] / "yuv420" / "frames"
                                       / model).iterdir())
        assert pngs == [f"{k:06d}.png" for k in range(0, FRAMES, EVERY)]


def test_farm_mvps_are_the_references_frame_by_frame(farm):
    c = CONFIG
    want = np.stack([ref_scene.mvp(k, c["fps"], c["fov_y"], c["width"],
                                   c["height"]) for k in range(FRAMES)])
    for readback in ("rgba", "yuv420"):
        # (models, frames, 4, 4): each chunk's, concatenated.
        mvps = farm["mvps"][readback]
        assert mvps.shape == (len(MODELS), FRAMES, 4, 4)
        for s in range(len(MODELS)):
            np.testing.assert_allclose(mvps[s], want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_on_the_card_yuv_snapshots_are_the_rgba_runs(tmp_path):
    """On the card the YUV path reads each due snapshot's RGBA back from
    the device: its PNGs are the RGBA readback's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    image, models, _, _ = write_farm_inputs(tmp_path / "in")
    for readback in ("rgba", "yuv420"):
        argv = farm_argv(image, models, tmp_path / readback, "--readback",
                         readback, frames=40)
        argv[argv.index("cpu")] = "cuda"
        tbatch.run_farm(tbatch.build_parser().parse_args(argv))
    for model in MODELS:
        for k in range(0, 40, EVERY):
            assert (snapshot(tmp_path / "yuv420", model, k).read_bytes()
                    == snapshot(tmp_path / "rgba", model, k).read_bytes())
