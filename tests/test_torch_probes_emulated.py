"""The probe kernels' CUDA source, run on the CPU, against the plain twins.

``csrc/probes.cu`` is compiled by the host C++ compiler against the
emulated CUDA runtime of ``test_torch_scan_emulated`` (each thread block
runs as ``blockDim`` OS threads, one block after another), with what this
file adds to it: ``__syncthreads`` as that runtime's barrier, the bit casts,
``cudaFuncSetAttribute`` as a no-op and one static buffer as the dynamic
shared memory. The package's own wrappers then launch the five kernels on
CPU tensors (parameter struct, staging and launch counts as on the card),
and every output must equal the twin's exactly (float32 compared as int32
bits). Every ``gather_accum`` instance the cases use runs here, and
``roll_accum``, ``onehot_dot``, ``transpose`` and ``march_top2``.

Built with ``-ffp-contract=off``, the host compiler contracts nothing, as
nvcc with ``--fmad=false`` does not; ``fmaf`` is the C library's correctly
rounded one. What this cannot show: that nvcc builds the file for
``sm_90a``, and how fast it runs; ``chip_smoke.py`` does.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.ops import cuda_build

from test_torch_scan_emulated import EMULATED_RUNTIME, emulated_source

torch.set_num_threads(1)

PROBES_RUNTIME = r"""
#include <string.h>
#define __shared__
#define __host__
inline void __syncthreads() { __syncthreads_or(false); }
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
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


# One case of every gather_accum instance (form, axis, dtype, accumulators),
# the 8-table, row-select and strided-index cases, and the other kernels;
# trips at which the sums run over several trips and index sets.
CASES = {
    "gp1_lane": 5, "gp1_sublane": 5, "gp1_flat": 5, "gp2_rowsel": 5,
    "gp2_b3": 3, "gp2_a3": 3, "gp3_f32_s8": 4, "gp3_u32_s8": 4,
    "gp3_fma_s8": 4, "gp4_mask_s32": 4, "gp5_multi": 3, "gp5_int": 64,
    "gp5_bitcast": 3, "gp6_fma": 3, "gp8_convert": 5, "gp8_gather": 5,
    "spm_p3_clip": 300, "spm_p3b_and": 300, "spm_p3c_mask": 300,
    "gp5_roll": 3, "gp1_onehot": 3, "spm_p1_transpose": 1,
    "spm_p2_march": 3,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_twin(emulated, name):
    case = probes.CASES[name]
    trips = CASES[name]
    ins = {k: torch.from_numpy(v)
           for k, v in probes.make_inputs(case, seed=11).items()}
    if name == "gp5_int":
        # Values above 2**20 make the probe's own 64 trips wrap the sum.
        ins["tab"] = ins["tab"] + 0x01234567
    got = probes.run_case(case, ins, trips)
    assert probes.LAUNCHES[case.kernel] == 1
    assert sum(probes.LAUNCHES.values()) == 1
    want = probes.run_case(case, ins, trips, plain=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_every_gather_instance_runs_here():
    key = lambda c: (c.form, c.axis, c.dtype, c.naccs)  # noqa: E731
    used = {key(c) for c in probes.cases_of("gather_accum")}
    assert used == {key(probes.CASES[n]) for n in CASES
                    if probes.CASES[n].kernel == "gather_accum"}
    assert {probes.CASES[n].kernel for n in CASES} == set(
        probes.KERNEL_NAMES)


@pytest.mark.parametrize("name", ["gp2_a3", "gp5_roll", "spm_p2_march"])
def test_copies_and_lane_order_equal_twin(emulated, name):
    """The runner's --copies (one output per blockIdx.z) and --order lanes
    (lane l's index l) through the kernels."""
    case = probes.CASES[name]
    ins = {k: torch.from_numpy(v) for k, v in
           probes.make_inputs(case, seed=2, order="lanes").items()}
    got = probes.run_case(case, ins, 3, copies=3)
    want = probes.run_case(case, ins, 3, plain=True, copies=3)
    assert got.shape == (3,) + case.out
    assert torch.equal(got, want)
    assert torch.equal(got[0], probes.run_case(case, ins, 3, plain=True))
