"""The probe kernels' CUDA source, run on the CPU, against the plain twins.

``csrc/probes.cu`` is compiled by the host C++ compiler against the
emulated CUDA runtime of ``test_torch_scan_emulated`` (each thread block
runs as ``blockDim`` OS threads, one block after another; its barriers
and bit casts), with what this file adds to it: ``float4`` and ``uint4``,
``__any_sync`` as a vote over the block (as ``test_torch_pair_emulated``
has it), ``cudaFuncSetAttribute`` as a no-op and one static buffer as the
dynamic shared memory. The package's own
wrappers then launch the five kernels on CPU tensors (parameter struct,
staging and launch counts as on the card), and every output must equal
the twin's exactly (float32 compared as int32 bits). Every
``gather_accum`` instance ``pick_gather`` can return runs here, and
``roll_accum``, ``onehot_dot``, ``transpose`` and ``march_top2``; so do
trip counts that leave the gather's and the march's unrolled loops a
remainder, the copied outputs and lane-order indices on a replicated and a
single-copy table layout, and the march on inputs built for its top 2's
corners (``probes.march.edge_inputs``).

Built with ``-ffp-contract=off``, the host compiler contracts nothing, as
nvcc with ``--fmad=false`` does not; ``fmaf`` is the C library's correctly
rounded one. What this cannot show: that nvcc builds the file for
``sm_90a``, and how fast it runs; ``chip_smoke.py`` does.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.ops import cuda_build
from depthrenderer_tpu_torch.probes import march

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


# A case of each gather unroll (1, 8, 32 with 4 accumulators, 64 sets: 16,
# 2, 1 and 1 trips a loop iteration) and the march (4 trips a chain group),
# at trip counts their loops do not divide and one longer.
@pytest.mark.parametrize("trips", [1, 3, 7, 37])
@pytest.mark.parametrize("name", ["gp1_lane", "gp3_f32_s8", "gp8_gather",
                                  "gp5_dense", "spm_p2_march"])
def test_trip_counts_equal_twin(emulated, name, trips):
    case = probes.CASES[name]
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
                                  "gp5_roll", "spm_p2_march"])
def test_copies_and_lane_order_equal_twin(emulated, name):
    """The runner's --copies (one output per blockIdx.z) and --order lanes
    (lane l's index l) through the kernels, on gather_accum's 32-copy (lane
    gather), 16-copy (8 tables) and single-copy (flat) table layouts."""
    case = probes.CASES[name]
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
