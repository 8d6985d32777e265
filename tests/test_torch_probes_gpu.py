"""The probe kernels (``csrc/probes.cu``) on an NVIDIA GPU against their
plain twins.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_probes_gpu.py

One test per kernel and index order runs every case of that kernel at its
check trip count (``probes.check_trips``) on the case's seeded inputs
(``--order random`` or ``lanes``), kernel and twin, and the two must be
equal bit for bit: the kernels take the twins' float32 steps in the same
order (built with ``--fmad=false``; the baselines' one multiply-add is
``fmaf`` there and an exact emulation in the twin). The kernels that copy
their output (``probes.COPIED``) compute 3 copies, on their own blocks;
march_top2 also runs on the inputs built for its top 2's corners,
onehot_dot on tables built for its bf16 split's corners (where the card's
tensor cores, not an emulation of them, take the parts) and roll_accum at
its edge shifts.
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


def check(case, ins, trips, copies):
    probes.reset_launch_counts()
    got = probes.run_case(case, ins, trips, copies=copies)
    assert probes.LAUNCHES[case.kernel] == 1, case.name
    want = probes.run_case(case, ins, trips, plain=True, copies=copies)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        case.name


@pytest.mark.parametrize("order", probes.ORDERS)
@pytest.mark.parametrize("kernel", probes.KERNEL_NAMES)
def test_kernel_equals_plain_twin(cuda, kernel, order):
    from depthrenderer_tpu_torch.probes import gather, march

    copies = 3 if kernel in probes.COPIED else 1
    for case in probes.cases_of(kernel):
        ins = {k: torch.from_numpy(v).to(cuda) for k, v in
               probes.make_inputs(case, seed=3, order=order).items()}
        check(case, ins, probes.check_trips(case), copies)
    if kernel == "march_top2":
        edges = [march.edge_inputs(n, seed=3) for n in march.EDGE_CASES]
    elif kernel == "onehot_dot":
        edges = [gather.onehot_edge_inputs(case, n, seed=3)
                 for n in gather.ONEHOT_EDGE_CASES]
    elif kernel == "roll_accum":
        edges = [gather.roll_edge_inputs(case, seed=3)]
    else:
        edges = []
    for inputs in edges:
        ins = {k: torch.from_numpy(v).to(cuda) for k, v in inputs.items()}
        check(case, ins, 5, copies)
