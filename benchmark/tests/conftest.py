"""Shared fixtures of the benchmark's CPU tests: the benchmark's files
copied under a temporary root with a tiny configuration and its cells added
as new files, so a run takes seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(name="tiny", width=128, height=72, texture_width=128,
            texture_height=72, depth_width=128, depth_height=72,
            mesh_density=5, vertices_per_side=33, triangles=2048,
            frames_per_clip=24)


def add_tiny(root: Path):
    """Copy the benchmark under ``root`` and add the ``tiny`` configuration
    and the cells ``tiny.frames`` and ``tiny.clip`` (one checked clip, six
    rows) as new files and entries."""
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((bench / "configs" / "hd1080_d10.json").read_text())
    cfg.update(TINY)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("frames", "clip"):
        w = json.loads((bench / "workloads" /
                        f"hd1080_d10.{kind}.json").read_text())
        w["config"] = "tiny"
        w["traffic"].update(scene_pool=2, warm_frames=20)
        w["check"].update(clips=1, rows=6)
        (bench / "workloads" / f"tiny.{kind}.json").write_text(json.dumps(w))
        b["workloads"].append({"name": f"tiny.{kind}", "config": "tiny",
                               "traffic": kind, "chips": 1, "why": "tests"})
        for m in b["end_to_end"] + b["per_layer"]:
            if f"hd1080_d10.{kind}" in m.get("workloads", []):
                m["workloads"].append(f"tiny.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return bench, b


@pytest.fixture
def make_tiny():
    return add_tiny


@pytest.fixture
def tiny(tmp_path):
    import torch

    torch.set_num_threads(2)
    return add_tiny(tmp_path)
