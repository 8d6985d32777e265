"""The farm cell (``vga_d8.farm``, driver ``farm``) on the CPU: a tiny copy
of it runs to a correct result; a dropped frame, two models' depth maps
swapped and the control (at the cell's own size) come out not correct; and
``farm_roofline``'s counts at ``vga_d8`` are the ones written out below."""

import json
import shutil

import numpy as np
import pytest

from benchmark import check, harness, scenes

SEED = 2**31 + 9
TINY = dict(name="tiny_farm", width=64, height=48, texture_width=64,
            texture_height=48, depth_width=64, depth_height=48,
            mesh_density=4, vertices_per_side=17, triangles=512,
            depth_maps=[{"name": "ground_truth"},
                        {"name": "noise_8", "scale": 8, "seed": 3}])


@pytest.fixture
def tiny_farm(tmp_path):
    """The benchmark under ``tmp_path`` with the cell ``tiny_farm.farm``
    (64x48, d4, two depth maps, 17 frames a model, a snapshot every 8, no
    warm job) added as new files and entries."""
    import torch

    torch.set_num_threads(2)
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.load_json(bench / "configs" / "vga_d8.json")
    cfg.update(TINY)
    (bench / "configs" / "tiny_farm.json").write_text(json.dumps(cfg))
    w = harness.load_json(bench / "workloads" / "vga_d8.farm.json")
    w["config"] = "tiny_farm"
    w["traffic"].update(models_per_job=2, frames_per_model=17,
                        png_every_frames=8, scene_pool=2, warm_jobs=0)
    w["check"].update(clips=1, rows=6)
    (bench / "workloads" / "tiny_farm.farm.json").write_text(json.dumps(w))
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    b["workloads"].append({"name": "tiny_farm.farm", "config": "tiny_farm",
                           "traffic": "farm", "chips": 1, "why": "tests"})
    for m in b["end_to_end"]:
        if m["name"] == "clip_fps":
            m["workloads"].append("tiny_farm.farm")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return bench, b


def run_tiny(tiny_farm):
    bench, b = tiny_farm
    result, _, _, run = harness.run_cell("tiny_farm.farm", SEED, 0.05,
                                         bench_dir=bench, benchmark=b,
                                         device="cpu")
    return result, run


def test_tiny_farm_is_correct(tiny_farm):
    result, run = run_tiny(tiny_farm)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"clip_fps", "setup_s"}
    assert run.frames == 2 * 17 * len(run.clips)
    assert result["checks"]["png_off1_share"]["value"] <= 0.02


def test_a_dropped_frame_is_not_correct(tiny_farm, monkeypatch):
    from depthrenderer_tpu_torch import writers

    write = writers.AsyncVideoWriter.write

    def drop_the_fifth(self, frame):
        self.seen = getattr(self, "seen", 0) + 1
        if self.seen != 5:
            write(self, frame)

    monkeypatch.setattr(writers.AsyncVideoWriter, "write", drop_the_fifth)
    result, _ = run_tiny(tiny_farm)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["avi_frames_short"]["value"] >= 2


def test_two_swapped_models_are_not_correct(tiny_farm, monkeypatch):
    from depthrenderer_tpu_torch import batch

    discover = batch.discover_models

    def swapped(*args):
        (a, da), (b, db) = discover(*args)
        return [(a, db), (b, da)]

    monkeypatch.setattr(batch, "discover_models", swapped)
    result, _ = run_tiny(tiny_farm)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["avi_wrong_model"]["value"] == 2


@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_is_not_correct_at_the_cells_size(seed, tmp_path):
    """The reference in float32 with TF32 products in the PNGs' place, at
    640x480 and d8, on fewer rows than the cell checks (only the reference
    runs)."""
    cell = "vga_d8.farm"
    workload = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    config = harness.load_json(harness.BENCH / "configs" /
                               f"{workload['config']}.json")
    workload["check"]["rows"] = 3
    run = harness.Run(cell, workload, config, seed, 0.0, "cpu")
    farm = harness.plugin(harness.BENCH, "drivers", "farm")
    driver = farm.Driver(run)
    colour, depth = scenes.make_scene(seed, 0, config["height"],
                                      config["width"])
    driver.images = [(colour, dict(zip(
        (m["name"] for m in config["depth_maps"]),
        farm.depth_maps(depth, config["depth_maps"]))))]
    for k in range(workload["check"]["clips"]):
        rng = check.clip_rng(seed, k)
        pick = int(rng.integers(8, driver.frames - 8))
        shots = [int(rng.choice(np.arange(0, driver.frames, driver.every)))
                 for _ in driver.models]
        rows = check.pick_rows(rng, config["height"], 3)
        driver.outputs[k] = (0, tmp_path / f"job{k}")
        driver.reservoir.put(k, (k, pick, shots, rows))
    values, _ = driver.check(control=True)
    limit = workload["check"]["limits"]["png_off1_share"]
    print(f"control png_off1_share {values['png_off1_share']:.4f} limit "
          f"{limit}")
    assert values["png_off1_share"] > limit


def test_roofline_counts_at_vga_d8():
    roof = harness.plugin(harness.BENCH, "metrics", "farm_roofline")
    cfg = harness.load_json(harness.BENCH / "configs" / "vga_d8.json")
    peak = json.loads((harness.BENCH / "peaks.json").read_text())[
        "NVIDIA H100 80GB HBM3"]
    n, px = 257, 640 * 480
    assert roof.snapshot_every(cfg) == 60
    # Grid xyz float32, the RGBA8 texture, the 4:2:0 planes, and the RGBA8
    # frame of one model-frame in 60 (the PNG snapshots).
    bytes_ = n * n * 12 + px * 4 + px * 3 // 2 + px * 4 // 60
    assert bytes_ == 2_502_668
    assert roof.model_frame_bytes(cfg) == pytest.approx(bytes_, rel=1e-15)
    # The MVP a vertex, barycentrics and a 4-texel blend a pixel.
    assert n * n * 32 + px * 40 == 14_401_568 == roof.ROOF.frame_flops(cfg)
    bound = 2_502_668 / 3.35e12   # the bytes' bound is the larger
    assert 14_401_568 / 67e12 < bound
    assert roof.model_frame_bound_s(cfg, peak) == pytest.approx(bound,
                                                                rel=1e-12)
    assert bound * 1e6 == pytest.approx(0.7471, abs=1e-4)
