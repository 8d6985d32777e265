"""The host side of the probe kernels' layout and of their SASS tally.

``probes.stripe`` and ``probes.staged_words`` model where gather_accum
stages each table word (bank-striped copies), and ``probes.wavefronts``
counts the shared-memory wavefronts a case's indices give under that
layout; the runner's bounds rest on both. Here the modelled layout is
built as an array and must hold, at every lookup of trip 0, the word the
plain twin gathers; the wavefront counts are checked where they are known
(32 copies or a sublane layout: none but one; the flat table in lane
order: one). ``cuda_build.parse_sass`` and ``sass_loops`` read a
cuobjdump listing and find the innermost loop and the stretch a branch
inside it skips.
"""

import numpy as np
import pytest

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.ops import cuda_build

GATHERS = [c for c in probes.cases_of("gather_accum")
           if c.form not in ("fma", "convert")]


def staged_table(case, tab, s0, l0):
    """The block's staged words as gather_accum_kernel writes them (row
    s0's block for a lane gather, columns l0.. for a sublane gather)."""
    lg = probes.stripe(case)
    tabs = tab.reshape((-1,) + tab.shape[-2:])
    if case.axis == "sublane":
        return np.ascontiguousarray(tabs[0][:, l0:l0 + 32]).reshape(-1)
    if case.axis == "flat":
        return tabs.reshape(-1)
    row = tabs[:, s0, :].reshape(-1)              # (t, w) -> t * C + w
    return np.repeat(row, 1 << lg)


@pytest.mark.parametrize("name", ["gp1_lane", "gp1_sublane", "gp1_flat",
                                  "gp2_rowsel", "gp5_multi", "spm_p3_clip",
                                  "spm_p3b_and"])
def test_staged_words_hold_the_gathered_words(name):
    case = probes.CASES[name]
    ins = probes.make_inputs(case, seed=4)
    tab, idx = ins["tab"], ins["idx"]
    s, l = case.out
    sets = idx.reshape((-1,) + idx.shape[-2:])[:case.unroll, :s, :l]
    sets = np.broadcast_to(sets, (len(sets), s, l))
    words = probes.staged_words(case, sets)
    n = len(sets)
    for si in range(0, s, max(1, s // 4)):
        for l0 in range(0, l, 32):
            st = staged_table(case, tab, si, l0)
            got = st[words[:, si, l0:l0 + 32]]
            tabs = tab.reshape((-1,) + tab.shape[-2:])
            for u in range(n):
                t = tabs[u % case.ntab]
                x = sets[u, si, l0:l0 + 32].astype(np.int64)
                if case.form in ("mask", "addmask"):
                    x = x & case.mask
                lanes = np.arange(l0, l0 + 32)
                if case.form == "clip2":
                    x = np.clip(x, 0, 255)
                    want = np.stack([t[si, np.clip(x, 0, 127)],
                                     t[si, 128 + np.clip(x - 128, 0, 127)]])
                    assert np.array_equal(got[[u, n + u]], want)
                    continue
                if case.form == "and2":
                    want = np.stack([t[si, x & 127], t[si, 128 + (x & 127)]])
                    assert np.array_equal(got[[u, n + u]], want)
                    continue
                if case.axis == "sublane":
                    want = t[x, lanes]
                elif case.axis == "flat":
                    want = t.reshape(-1)[x]
                else:
                    want = t[si, x]
                assert np.array_equal(got[u], want)


@pytest.mark.parametrize("order", probes.ORDERS)
def test_wavefronts_of_each_layout(order):
    for case in GATHERS:
        waves = probes.wavefronts(case, probes.make_inputs(case, 1, order))
        if case.axis == "sublane" or probes.stripe(case) == 5 or (
                case.axis == "flat" and order == "lanes"):
            assert waves == 1.0, case.name
        elif case.axis == "flat":
            assert 3.0 < waves < 4.5, case.name
        else:                                      # 8 tables, 16 copies
            assert probes.stripe(case) == 4 and waves == 2.0, case.name
    assert probes.stripe(probes.CASES["gp1_flat"]) == 0
    assert probes.stripe(probes.CASES["gp1_lane"]) == 5


LISTING = """
\t\tFunction : _Z19gather_accum_kernelILi2ELi0ELi0ELi1ELi1EEvPKjS1_Pj11ProbeParams
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   LDS R4, [R5] ;
        /*0030*/                   FADD R6, R6, R2 ;
        /*0040*/               @P0 BRA 0x70 ;
        /*0050*/                   FSEL R7, R6, R8, P1 ;
        /*0060*/                   SEL R9, R10, R11, P1 ;
        /*0070*/                   NOP ;
        /*0080*/              @!P2 BRA 0x10 ;
        /*0090*/                   IADD3 R12, R12, 0x1, RZ ;
        /*00a0*/              @!P3 BRA 0x0 ;
        /*00b0*/                   EXIT ;
"""


def test_sass_loops_find_the_innermost_loop():
    kernels = cuda_build.parse_sass(LISTING)
    ins = kernels["gather_accum_kernel<2, 0, 0, 1, 1>"]
    assert len(ins) == 12
    loops = cuda_build.sass_loops(ins)
    assert [(a, b) for a, b, _, _ in loops] == [(0x10, 0x80)]
    _, _, ops, guarded = loops[0]
    assert ops == {"LDS": 2, "FADD": 1, "BRA": 2, "FSEL": 1, "SEL": 1}
    assert guarded == {"FSEL": 1, "SEL": 1}
