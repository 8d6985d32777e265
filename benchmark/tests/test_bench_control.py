"""The control, the reference one precision step down (float32 with TF32
products) in the program's place, comes out not correct against each
cell's own limit at the cell's own size, on three seeds. Only the
reference runs: the check reads seeded rows of the picked frames. As many
frames are checked as the cell checks; fewer rows, to keep the test
short."""

import pytest

from benchmark import check, harness, scenes

PRECISION_NUMBER = {"frames": "off1_share", "clip": "png_off1_share"}


def control_reading(cell, seed, rows, tmp_path):
    workload = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    config = harness.load_json(harness.BENCH / "configs" /
                               f"{workload['config']}.json")
    clips = workload["check"]["clips"]
    workload["check"]["rows"] = rows
    run = harness.Run(cell, workload, config, seed, 0.0, "cpu")
    driver = harness.plugin(harness.BENCH, "drivers",
                            workload["driver"]).Driver(run)
    driver.scenes = [scenes.make_scene(seed, 0, config["height"],
                                       config["width"])]
    driver.tmp = tmp_path
    for k in range(clips):
        rng = check.clip_rng(seed, k)
        pick = int(rng.integers(8, config["frames_per_clip"] - 8))
        picked = check.pick_rows(rng, config["height"], rows)
        if workload["driver"] == "clip":
            driver.outputs[k] = (0, str(tmp_path / "none.avi"),
                                 str(tmp_path / "none.png"))
            driver.reservoir.put(k, (k, pick, picked))
        else:
            driver.reservoir.put(k, (k, 0, pick, picked, None))
            driver.short[k] = 0
    values, _ = driver.check(control=True)
    name = PRECISION_NUMBER[workload["driver"]]
    return values[name], workload["check"]["limits"][name]


@pytest.mark.parametrize("cell, rows", [
    ("hd1080_d10.frames", 4), ("hd1080_d10.clip", 4),
    ("uhd4k_d12_cull.frames", 2)])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_is_not_correct(cell, rows, seed, tmp_path):
    value, limit = control_reading(cell, seed, rows, tmp_path)
    assert value > limit
