"""Whole runs of the tiny cells on the CPU (the harness's look for a chip
skipped): a well-formed result, files dropped in as new cells, and the
check's verdict with the timed path broken underneath."""

import json

import numpy as np
import pytest

from benchmark import harness


SEED = 2**31 + 5


def last_line(result, compared, notes, capsys):
    assert harness.report(result, compared, notes) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


@pytest.mark.parametrize("kind, e2e", [
    ("frames", {"render_fps", "setup_s"}),
    ("clip", {"clip_fps", "setup_s"}),
])
def test_tiny_run_ends_in_a_well_formed_line(tiny, kind, e2e, capsys):
    bench, b = tiny
    result, compared, _, run = harness.run_cell(
        f"tiny.{kind}", SEED, 0.5, bench_dir=bench, benchmark=b,
        device="cpu")
    line = last_line(result, compared, run.notes, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == e2e
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    assert line["attempted"] == len(run.clips) >= 1


def test_new_cell_config_driver_and_metric_as_files(tmp_path, make_tiny,
                                                    capsys):
    """A cell, its configuration, a driver and a per-layer metric added as
    new files and BENCHMARK.json entries run with no edit to the harness."""
    bench, b = make_tiny(tmp_path)
    cfg = harness.load_json(bench / "configs" / "tiny.json")
    cfg["name"] = "tiny2"
    (bench / "configs" / "tiny2.json").write_text(json.dumps(cfg))
    (bench / "drivers" / "count.py").write_text(
        "class Driver:\n"
        "    def __init__(self, run):\n"
        "        self.run = run\n"
        "    def setup(self):\n"
        "        pass\n"
        "    def clip(self, k):\n"
        "        with self.run.span('bench.count'):\n"
        "            return self.run.config['frames_per_clip']\n"
        "    def release(self):\n"
        "        pass\n"
        "    def check(self, control=False):\n"
        "        return {'zero': 0.0}, set()\n"
        "    def close(self):\n"
        "        pass\n")
    (bench / "metrics" / "count_spans.py").write_text(
        "def read(run):\n"
        "    return len(run.span_seconds('bench.count')) or None\n")
    (bench / "workloads" / "tiny2.count.json").write_text(json.dumps({
        "config": "tiny2", "driver": "count", "chips": 1, "why": "test",
        "traffic": {"trace_clips": 1}, "check": {"limits": {"zero": 0}}}))
    b["configs"].append({"name": "tiny2", "source": "test",
                         "file": "benchmark/configs/tiny2.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny2.count", "config": "tiny2",
                           "traffic": "count", "chips": 1, "why": "test"})
    b["end_to_end"][1]["workloads"].append("tiny2.count")   # render_fps
    b["per_layer"].append({"name": "count_spans", "unit": "spans",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "render_fps",
                           "workloads": ["tiny2.count"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    result, compared, _, run = harness.run_cell(
        "tiny2.count", SEED, 0.05, bench_dir=bench, device="cpu")
    line = last_line(result, compared, run.notes, capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"render_fps", "setup_s"}
    result, _, _, run = harness.run_cell(
        "tiny2.count", SEED, 0.05, True, bench_dir=bench, device="cpu")
    assert result["metrics"]["count_spans"]["value"] == len(run.clips)


def _broken(kind, render_clip):
    """``render_clip`` with a fault planted where the frames are made."""

    def wrapped(*args, on_frames=None, **kwargs):
        first = {}

        def sink(start, frames):
            frames = np.array(frames)
            if kind == "state_unchanged":
                # The camera never advances: every frame is the clip's first.
                first.setdefault("frame", frames[0].copy())
                frames[:] = first["frame"]
            elif kind == "half_left_out":
                frames = frames[:len(frames) // 2]
            elif kind == "answer_altered":
                frames[..., 0] ^= 0x10
            on_frames(start, frames)

        return render_clip(*args, on_frames=sink, **kwargs)

    return wrapped


FAULTS = ("state_unchanged", "half_left_out", "answer_altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("kind", ["frames", "clip"])
def test_a_broken_timed_path_is_not_correct(tiny, kind, fault, monkeypatch):
    from depthrenderer_tpu_torch import cli, render

    target = render if kind == "frames" else cli
    monkeypatch.setattr(target, "render_clip",
                        _broken(fault, target.render_clip))
    bench, b = tiny
    result, compared, _, _ = harness.run_cell(
        f"tiny.{kind}", SEED, 0.5, bench_dir=bench, benchmark=b,
        device="cpu")
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1
