"""The port's scan passes against the JAX kernel without the colfix fan, at
hyps 1 and 2 (scene, bars and their reasons: test_torch_scan_kernel.py)."""

import pytest

from test_torch_scan_kernel import check_against_jax, jax_config


@pytest.mark.parametrize("hyps", [1, 2])
def test_frames_and_records_match_jax_without_colfix(hyps):
    check_against_jax(jax_config(hyps=hyps, colfix=None))
