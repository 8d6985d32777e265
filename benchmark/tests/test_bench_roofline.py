"""The roofline's bound: byte and operation counts from the configurations'
sizes alone."""

import json

import pytest

from benchmark import harness

ROOF = harness.plugin(harness.BENCH, "metrics", "raster_roofline")
PEAK = json.loads((harness.BENCH / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("name, nbytes, flops, bound_us", [
    ("hd1080_d10", 29_196_300, 116_564_000, 8.715),
    ("uhd4k_d12_cull", 267_780_108, 868_909_088, 79.93),
])
def test_counts(name, nbytes, flops, bound_us):
    cfg = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    assert ROOF.frame_bytes(cfg) == nbytes
    assert ROOF.frame_flops(cfg) == flops
    # Bytes bound in both.
    assert nbytes / PEAK["hbm_bytes_per_s"] > flops / PEAK["fp32_flops_per_s"]
    assert ROOF.frame_bound_s(cfg, PEAK) * 1e6 == pytest.approx(bound_us,
                                                                 abs=0.01)


def test_no_trace_reads_nothing():
    class R:
        trace = None
        device_kind = "NVIDIA H100 80GB HBM3"
        config = {}

    assert ROOF.read(R()) is None
