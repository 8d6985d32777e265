"""The import check: top-level module names compared whole, and a run that
loaded a forbidden package prints no result and fails."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import harness


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(
        ["depthrenderer_tpu_torch", "depthrenderer_tpu_torch.ops.raster_scan",
         "torch", "numpy", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["depthrenderer_tpu", "depthrenderer_tpu.ops"]) == [
            "depthrenderer_tpu"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]


def test_the_harness_and_the_port_load_no_forbidden_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness, check, scenes, avi, devtrace; "
            "[harness.plugin(harness.BENCH, 'drivers', d) "
            " for d in ('frames', 'clip')]; "
            "import depthrenderer_tpu_torch.render, depthrenderer_tpu_torch.cli; "
            "print(harness.forbidden_modules())") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


@pytest.mark.parametrize("name", ["jax", "depthrenderer_tpu.render"])
def test_report_refuses_a_run_that_loaded_one(name, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}}
    assert harness.report(result, [], {}) == 4
    out, err = capsys.readouterr()
    assert out == "" and name.split(".")[0] in err


def test_report_prints_the_result_last(capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}}
    from benchmark.check import Compared

    assert harness.report(result, [Compared("x", 0.5, 1.0)], {"a": 1}) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-1] == "[check] x 0.5 limit 1.0 ok"
