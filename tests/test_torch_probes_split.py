"""onehot_dot's split of a float32 into three bf16 parts, on its own.

``probes.gather.split_bf16x3`` is the formula ``csrc/probes.cu``'s
``split_bf16x3`` uses for the table before the tensor cores multiply it
(hi: x toward zero to bf16; r = x - hi, times 2**64 where |hi| < 2**-100;
mid: r toward zero; lo = r - mid), and ``join_bf16x3`` the kernel's
``(lo + mid) * scale + hi``. Here, in numpy: every part is a bf16 (its
float32's low 16 bits are 0), the parts add up to x exactly in real
arithmetic, and the join gives x back bit for bit (-0.0 as +0.0), on a
seeded sample over the whole normal range and on the edge values the
kernel's tests use; every part is a normal bf16 or 0, but hi where x is a
float32 subnormal.
"""

import numpy as np
import pytest

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.probes import gather

F32_MAX = np.finfo(np.float32).max
F32_TINY = np.finfo(np.float32).tiny            # 2**-126


def check_split(x):
    x = np.asarray(x, dtype=np.float32)
    hi, mid, lo = gather.split_bf16x3(x)
    for part in (hi, mid, lo):
        assert part.dtype == np.float32
        assert not (part.view(np.uint32) & 0xFFFF).any()
        assert np.isfinite(part).all()
        # A normal bf16 or 0, but hi where x is a float32 subnormal.
        normal = (np.abs(part) >= F32_TINY) | (part == 0)
        assert normal[np.abs(x) >= F32_TINY].all() if part is hi else \
            normal.all()
    # Exact in real arithmetic: the parts have at most 8 significant bits
    # each, so these float64 sums round nothing.
    scale = np.where(np.abs(hi) < 2.0**-100, 2.0**-64, 1.0)
    parts = (hi.astype(np.float64) + (mid.astype(np.float64) + lo) * scale)
    assert np.array_equal(parts, x.astype(np.float64))
    joined = gather.join_bf16x3(hi, mid, lo)
    assert joined.dtype == np.float32
    nonzero = x != 0
    assert np.array_equal(joined.view(np.uint32)[nonzero],
                          x.view(np.uint32)[nonzero])
    assert not joined.view(np.uint32)[~nonzero].any()


def test_seeded_sample_over_the_normal_range():
    rng = np.random.default_rng(0)
    check_split(gather.full_significands(rng, 200_000, -126, 127))
    bits = rng.integers(0x00800000, 0x7F800000, 200_000, dtype=np.int64)
    signs = rng.integers(0, 2, 200_000, dtype=np.int64) << 31
    check_split((bits | signs).astype(np.uint32).view(np.float32))


@pytest.mark.parametrize("name", gather.ONEHOT_EDGE_CASES)
def test_edge_tables(name):
    case = probes.CASES["gp1_onehot"]
    check_split(gather.onehot_edge_inputs(case, name, seed=9)["tab"])


def test_edge_values():
    below = np.nextafter(np.float32(2.0**-100), np.float32(0))
    values = [0.0, -0.0, 1.0, -1.0, F32_MAX, -F32_MAX, F32_TINY, -F32_TINY,
              2.0**-100, below, -below, 2.0**-120 * (2 - 2.0**-23),
              2.0**120 * (2 - 2.0**-23), -(2.0**120) * (1 + 2.0**-23),
              np.float32(1 / 3), np.float32(np.pi)]
    check_split(np.array(values, dtype=np.float32))
    # Every significand at one exponent in each branch of the split.
    frac = np.arange(1 << 23, dtype=np.uint32)
    for exp in (127 - 110, 127, 127 + 120):
        check_split(((np.uint32(exp) << 23) | frac).view(np.float32))
