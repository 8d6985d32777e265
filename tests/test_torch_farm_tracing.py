"""The batch farm's spans and counters (``depthrenderer_tpu_torch.profiling``)
on the CPU: ``batch.farm`` is a job's root and its request reaches the
encoder threads, ``batch.frames`` counts model-frames, a due snapshot is
read once on the YUV path, and the spans cost next to nothing with the
profiler off."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from depthrenderer_tpu_torch import batch as tbatch
from depthrenderer_tpu_torch import profiling
from test_torch_farm_reference import CONFIG, farm_argv, write_farm_inputs

torch.set_num_threads(1)

SMALL = dict(CONFIG, width=48, height=36, texture_width=48,
             texture_height=36, mesh_density=3)
MAPS = [{"name": "ground_truth"}, {"name": "noise_8", "scale": 8, "seed": 3}]
FRAMES, EVERY = 17, 8   # two chunks; snapshots at 0, 8 and 16
FARM_SPANS = ("batch.farm", "batch.dispatch", "batch.snapshot_read")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.adopt(None)
    profiling.reset()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    image, models, _, _ = write_farm_inputs(
        tmp_path_factory.mktemp("farm_trace"), SMALL, MAPS)
    return image, models


def job(inputs, out, readback="yuv420"):
    image, models = inputs
    return tbatch.run_farm(tbatch.build_parser().parse_args(farm_argv(
        image, models, out, "--readback", readback, config=SMALL,
        frames=FRAMES, every=EVERY)))


def test_the_farm_is_the_root_and_its_request_reaches_the_encoders(
        inputs, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        job(inputs, tmp_path)
    kept = profiling.snapshot()["kept"]
    root, = [s for s in kept if s.name == "batch.farm"]
    assert root.request == root.id and root.parent is None
    assert {s.request for s in kept} == {root.id}
    for name in FARM_SPANS[1:]:
        assert {s.parent for s in kept if s.name == name} == {root.id}
    encodes = [s for s in kept if s.name == "writer.encode"]
    assert len(encodes) == len(MAPS) * FRAMES
    assert {s.thread for s in encodes}.isdisjoint({root.thread})
    assert len({s.thread for s in encodes}) == len(MAPS)   # one a model
    assert all(s.parent == root.id for s in encodes)


@pytest.mark.parametrize("readback", ["rgba", "yuv420"])
def test_frames_count_model_frames_and_each_due_snapshot_is_read_once(
        inputs, tmp_path, readback):
    job(inputs, tmp_path, readback)
    snap = profiling.snapshot()
    assert snap["counters"]["batch.frames"] == len(MAPS) * FRAMES
    assert snap["counters"]["writer.frames"] == len(MAPS) * FRAMES
    chunks = -(-FRAMES // tbatch.raster_scan.FRAME_GROUP)
    spans = snap["spans"]
    assert spans["batch.farm"]["calls"] == 1
    assert spans["batch.dispatch"]["calls"] == chunks
    due = len(range(0, FRAMES, EVERY))
    if readback == "yuv420":
        assert spans["batch.snapshot_read"]["calls"] == len(MAPS) * due
    else:   # the RGBA readback hands the frames themselves
        assert "batch.snapshot_read" not in spans
    pngs = list((tmp_path / "frames").rglob("*.png"))
    assert len(pngs) == len(MAPS) * due


def test_the_farms_spans_cost_under_half_a_percent_of_a_job(inputs,
                                                            tmp_path):
    t0 = time.perf_counter()
    job(inputs, tmp_path)
    wall = time.perf_counter() - t0
    snap = profiling.snapshot()
    assert snap["kept"] == []   # the profiler is off: nothing kept
    spans = sum(snap["spans"][n]["calls"] for n in FARM_SPANS)
    counts = snap["spans"]["batch.dispatch"]["calls"]   # one count a chunk
    reps = 20_000
    t0 = time.perf_counter()
    for _ in range(reps):
        with profiling.span("test.cost"):
            profiling.count("test.cost")
    each = (time.perf_counter() - t0) / reps
    cost = (spans + counts) * each
    print(f"{spans} spans and {counts} counts a job: {cost * 1e6:.1f} us "
          f"of {wall:.3f} s ({100 * cost / wall:.5f} %)")
    assert cost < 0.005 * wall
