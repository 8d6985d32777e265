"""The probe kernels' CUDA source, run on the CPU, against the plain twins.

``csrc/probes.cu`` is compiled by the host C++ compiler against the
emulated CUDA runtime of ``test_torch_scan_emulated`` (each thread block
runs as ``blockDim`` OS threads, one block after another; its barriers
and bit casts), with what this file adds to it: ``float4`` and ``uint4``,
``__any_sync`` as a vote over the block (as ``test_torch_pair_emulated``
has it), ``cudaFuncSetAttribute`` as a no-op, one static buffer as the
dynamic shared memory, and ``mma_bf16_16816``, the tensor-core instruction
of ``onehot_dot`` (``mma.sync`` m16n8k16, bf16 in, f32 accumulate), as a
collective over the block built from the PTX ISA's fragment layouts. The
package's own wrappers then launch the five kernels on CPU tensors
(parameter struct, staging and launch counts as on the card), and every
output must equal the twin's exactly (float32 compared as int32 bits).
Every ``gather_accum`` instance ``pick_gather`` can return runs here, and
``roll_accum``, ``onehot_dot``, ``transpose`` and ``march_top2``; so do
trip counts that leave the gather's and the march's unrolled loops a
remainder (and ``onehot_dot``'s four-trip rounds a part of one), the copied
outputs and lane-order indices on a replicated and a single-copy table
layout, the march on inputs built for its top 2's corners
(``probes.march.edge_inputs``), ``onehot_dot`` on tables built for its
bf16 split's corners and on rows that wrap past the last cell
(``probes.gather.onehot_edge_inputs``), and ``roll_accum`` at the edge
shifts 0, 1, 127, 128 and 255.

Built with ``-ffp-contract=off``, the host compiler contracts nothing, as
nvcc with ``--fmad=false`` does not; ``fmaf`` is the C library's correctly
rounded one. What this cannot show: that nvcc builds the file for
``sm_90a``, how the card's tensor cores round, and how fast it runs;
``chip_smoke.py`` and ``test_torch_probes_gpu`` do.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.ops import cuda_build
from depthrenderer_tpu_torch.probes import gather, march

from test_torch_scan_emulated import EMULATED_RUNTIME, emulated_source

torch.set_num_threads(1)

PROBES_RUNTIME = r"""
#include <string.h>
// probes.cu's one shared array is the extern probe_smem below.
#undef __shared__
#define __shared__
#define __host__
#define __align__(n)
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
// A warp vote: every thread of a block runs the same loop, so a vote over
// the block is taken wherever a vote of the thread's warp would be, and
// more often (the work it guards is exact either way).
inline bool __any_sync(unsigned, bool b) { return __syncthreads_or(b); }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  return 0;
}
alignas(16) uint32_t probe_smem[232448 / 4];
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (d += A x B) with the
// fragments as the PTX ISA lays them out, groupID = lane >> 2 and
// threadID_in_group = lane % 4: A's element a_i (i = 0 .. 7; register i / 2,
// even i in its low 16 bits) at row groupID (+ 8 for i = 2, 3, 6, 7) and
// column 2 * threadID_in_group + (i & 1) (+ 8 for i >= 4); B's b_i (i = 0 ..
// 3) at row 2 * threadID_in_group + (i & 1) (+ 8 for i >= 2), column
// groupID; C's and D's c_i at row groupID (+ 8 for i >= 2), column 2 *
// threadID_in_group + (i & 1). A collective over the block, as __any_sync
// is: each thread posts its fragments under (warp, lane), one barrier (the
// scratch alternates by call, so a thread's next post cannot overwrite
// what another is still reading), then each computes its own elements of D
// from its warp's 32 lanes, the products summed in double.
struct MmaFrags {
  uint32_t a[4], b[2];
};
inline MmaFrags g_mma[2][32][32];
inline thread_local int t_mma = 0;
inline float bf16_at(uint32_t reg, int i) {
  return __uint_as_float(((reg >> (16 * (i & 1))) & 0xFFFFu) << 16);
}
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, slot = t_mma++ & 1;
  g_mma[slot][warp][lane] = {{a[0], a[1], a[2], a[3]}, {b[0], b[1]}};
  __syncthreads();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int group = l >> 2, tig = l & 3;
    const MmaFrags& f = g_mma[slot][warp][l];
    for (int i = 0; i < 8; ++i)
      A[group + ((i >> 1) & 1) * 8][2 * tig + (i & 1) + (i >= 4) * 8] =
          bf16_at(f.a[i / 2], i);
    for (int i = 0; i < 4; ++i)
      B[2 * tig + (i & 1) + (i >= 2) * 8][group] = bf16_at(f.b[i / 2], i);
  }
  const int group = lane >> 2, tig = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = group + (i >= 2) * 8, col = 2 * tig + (i & 1);
    double sum = d[i];
    for (int k = 0; k < 16; ++k) sum += (double)A[row][k] * B[k][col];
    d[i] = (float)sum;
  }
}
"""


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    d = tmp_path_factory.mktemp("probes_emu")
    (d / "emu.h").write_text(EMULATED_RUNTIME + PROBES_RUNTIME)
    (d / "probes.cpp").write_text(emulated_source(
        (cuda_build.CSRC / "probes.cu").read_text(), launches=5))
    cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-I", str(d), "-o", str(d / "libprobes.so"),
           str(d / "probes.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return probes.bind(ctypes.CDLL(str(d / "libprobes.so")))


@pytest.fixture
def emulated(emulated_lib, monkeypatch):
    """Route the probe wrappers to the emulated kernels for CPU tensors
    (until the test ends) and set the launch counters to 0."""

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(probes, "_lib", emulated_lib)
    monkeypatch.setattr(probes, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(cuda_build, "check_cuda", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    probes.reset_launch_counts()


# One case of every gather_accum instance (form, axis, dtype, accumulators,
# index sets), the 8-table, row-select and strided-index cases, and the
# other kernels; trips at which the sums run over several trips and index
# sets.
CASES = {
    "gp1_lane": 5, "gp1_sublane": 5, "gp1_flat": 5, "gp2_rowsel": 5,
    "gp2_b3": 3, "gp2_a3": 3, "gp3_f32_s8": 4, "gp3_u32_s8": 4,
    "gp3_fma_s8": 4, "gp4_mask_s32": 4, "gp5_dense": 3, "gp5_multi": 3,
    "gp5_int": 64, "gp5_bitcast": 3, "gp6_fma": 3, "gp8_convert": 5,
    "gp8_gather": 5, "spm_p3_clip": 300, "spm_p3b_and": 300,
    "spm_p3c_mask": 300, "gp5_roll": 3, "gp1_onehot": 3,
    "spm_p1_transpose": 1, "spm_p2_march": 3,
}


def emulated_check(case, ins, trips, copies=1):
    """The kernel (one launch) against the twin, bit for bit."""
    probes.reset_launch_counts()
    got = probes.run_case(case, ins, trips, copies=copies)
    assert probes.LAUNCHES[case.kernel] == 1
    assert sum(probes.LAUNCHES.values()) == 1
    want = probes.run_case(case, ins, trips, plain=True, copies=copies)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_twin(emulated, name):
    case = probes.CASES[name]
    trips = CASES[name]
    ins = {k: torch.from_numpy(v)
           for k, v in probes.make_inputs(case, seed=11).items()}
    if name == "gp5_int":
        # Values above 2**20 make the probe's own 64 trips wrap the sum.
        ins["tab"] = ins["tab"] + 0x01234567
    emulated_check(case, ins, trips)


def pick_gather_instances():
    """The (form, axis, dtype, accumulators, index sets) instances
    ``pick_gather`` in csrc/probes.cu can return, read from its source (the
    enums' codes from their declarations, which must be the package's)."""
    src = (cuda_build.CSRC / "probes.cu").read_text()
    codes = {}
    for enum, table in (("Form", probes.FORMS), ("Axis", probes.AXES),
                        ("Dtype", probes.DTYPES)):
        names = re.search(rf"enum {enum} {{([^}}]*)}}", src).group(1)
        names = [n.strip() for n in names.split(",")]
        assert len(names) == len(table) == len(set(table.values()))
        assert sorted(table.values()) == list(range(len(names)))
        codes.update({n: i for i, n in enumerate(names)})
    body = src[src.index("GatherFn pick_gather("):]
    body = body[:body.index("return nullptr;")]
    return {(codes[f], codes[a], codes[d], int(n), int(u)) for f, a, d, n, u
            in re.findall(r"PROBE_PICK\((\w+), (\w+), (\w+), (\d+), (\d+)\)",
                          body)}


def test_every_gather_instance_runs_here():
    def key(c):
        return (probes.FORMS[c.form], probes.AXES[c.axis],
                probes.DTYPES[c.dtype], c.naccs, c.unroll)

    used = {key(c) for c in probes.cases_of("gather_accum")}
    assert used == pick_gather_instances()
    assert used == {key(probes.CASES[n]) for n in CASES
                    if probes.CASES[n].kernel == "gather_accum"}
    assert {probes.CASES[n].kernel for n in CASES} == set(
        probes.KERNEL_NAMES)


# onehot_dot at 16 of the probe's 1,024 rows (two blocks; each still sweeps
# all 1,536 cells): under the emulation each of its mma is a barrier of the
# block's 256 threads.
ONEHOT_SMALL = dataclasses.replace(probes.CASES["gp1_onehot"], out=(16, 8),
                                   index=(16, 1))


def emulated_case(name):
    return ONEHOT_SMALL if name == "gp1_onehot" else probes.CASES[name]


# A case of each gather unroll (1, 8, 32 with 4 accumulators, 64 sets: 16,
# 2, 1 and 1 trips a loop iteration), the march (4 trips a chain group),
# the roll (64 sets in stages of 16) and onehot_dot (rounds of 4 trips), at
# trip counts their loops do not divide and one longer.
@pytest.mark.parametrize("trips", [1, 3, 7, 37])
@pytest.mark.parametrize("name", ["gp1_lane", "gp3_f32_s8", "gp8_gather",
                                  "gp5_dense", "spm_p2_march", "gp5_roll",
                                  "gp1_onehot"])
def test_trip_counts_equal_twin(emulated, name, trips):
    case = emulated_case(name)
    ins = {k: torch.from_numpy(v)
           for k, v in probes.make_inputs(case, seed=trips).items()}
    emulated_check(case, ins, trips)


@pytest.mark.parametrize("name", march.EDGE_CASES)
def test_march_top2_edge_inputs_equal_twin(emulated, name):
    """Ties for both places, products of exactly 0, rows with no crossing,
    and the pair of hits at column 0 and the wrap column C - 1 (5 trips:
    one group of 4 chains and one trip alone)."""
    case = probes.CASES["spm_p2_march"]
    ins = {k: torch.from_numpy(v) for k, v in
           march.edge_inputs(name, seed=7).items()}
    got = emulated_check(case, ins, 5)
    if name == "wrap_pair":
        assert set(got[0::4].unique().tolist()) <= {0.0, 5 * 255.0}


@pytest.mark.parametrize("name", ["gp2_a3", "gp1_flat", "gp5_multi",
                                  "gp5_roll", "spm_p2_march", "gp1_onehot"])
def test_copies_and_lane_order_equal_twin(emulated, name):
    """The runner's --copies (one output per blockIdx.z) and --order lanes
    (lane l's index l) through the kernels, on gather_accum's 32-copy (lane
    gather), 16-copy (8 tables) and single-copy (flat) table layouts."""
    case = emulated_case(name)
    ins = {k: torch.from_numpy(v) for k, v in
           probes.make_inputs(case, seed=2, order="lanes").items()}
    got = probes.run_case(case, ins, 3, copies=3)
    want = probes.run_case(case, ins, 3, plain=True, copies=3)
    assert got.shape == (3,) + case.out
    assert torch.equal(got, want)
    assert torch.equal(got[0], probes.run_case(case, ins, 3, plain=True))


@pytest.mark.parametrize("shape", [(45, 70), (8, 256), (33, 1)])
def test_transpose_tiles_equal_twin(emulated, shape):
    """The transpose's 32 x 32 shared-memory tiles, ragged in both
    dimensions (partial tiles at the bottom and right edges), at the
    probe's 8 x 256 and as a single column, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    got = march.transpose(x)
    assert probes.LAUNCHES["transpose"] == 1
    assert torch.equal(got.view(torch.int32),
                       march.transpose_plain(x).view(torch.int32))


@pytest.mark.parametrize("name", gather.ONEHOT_EDGE_CASES)
def test_onehot_edge_inputs_equal_twin(emulated, name):
    """Full 24-bit significands, magnitudes across the split's 2**-100 down
    to 2**-126 and up to 2**120, negative values, +-0.0, float32
    subnormals, and rows starting at cells R - 1 .. R - 4 (5 trips: each
    wraps to cell 0 and on)."""
    ins = {k: torch.from_numpy(v) for k, v in
           gather.onehot_edge_inputs(ONEHOT_SMALL, name, seed=9).items()}
    emulated_check(ONEHOT_SMALL, ins, 5)


def test_roll_edge_shifts_equal_twin(emulated):
    """Shifts 0, 1, 127, 128 and 255 among the 64 sets."""
    case = probes.CASES["gp5_roll"]
    ins = {k: torch.from_numpy(v)
           for k, v in gather.roll_edge_inputs(case, seed=4).items()}
    emulated_check(case, ins, 3)
