"""On the card: a short run of each cell is correct, and its control is not
(``python -m pytest --noconftest -m gpu benchmark/tests``)."""

import pytest

from benchmark import check, harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell, seconds", [
    ("hd1080_d10.frames", 2.0),
    ("uhd4k_d12_cull.frames", 6.0),
    ("hd1080_d10.clip", 1.0),
])
def test_short_run_correct_and_control_not(cell, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.set_cache_dirs()
    result, compared, control, _ = harness.run_cell(
        cell, 2**31 + 4242, seconds, control=True)
    assert result["correct"] is True, result["checks"]
    workload = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    judged = check.judge(control, workload["check"]["limits"])
    assert not all(c.ok for c in judged), control
