"""The probe kernels (``csrc/probes.cu``) on an NVIDIA GPU against their
plain twins.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_probes_gpu.py

One test per kernel runs every case of that kernel at its check trip count
(``probes.check_trips``) on the case's seeded inputs, kernel and twin, and
the two must be equal bit for bit: the kernels take the twins' float32
steps in the same order (built with ``--fmad=false``; the baselines' one
multiply-add is ``fmaf`` there and an exact emulation in the twin).
"""

import pytest
import torch

from depthrenderer_tpu_torch import probes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", probes.KERNEL_NAMES)
def test_kernel_equals_plain_twin(cuda, kernel):
    for case in probes.cases_of(kernel):
        ins = {k: torch.from_numpy(v).to(cuda)
               for k, v in probes.make_inputs(case, seed=3).items()}
        trips = probes.check_trips(case)
        probes.reset_launch_counts()
        got = probes.run_case(case, ins, trips)
        assert probes.LAUNCHES[kernel] == 1, case.name
        want = probes.run_case(case, ins, trips, plain=True)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            case.name
