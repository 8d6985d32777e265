"""The port's scan passes against the JAX kernel at hyps 2 with the colfix
fan (scene, bars and their reasons: test_torch_scan_kernel.py)."""

from test_torch_scan_kernel import check_against_jax, jax_config


def test_frames_and_records_match_jax_hyps2_colfix1():
    check_against_jax(jax_config(hyps=2, colfix=1))
