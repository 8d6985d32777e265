"""The port's march probes against ``experiments/scan_probe_march.py``.

The five cases whose TPU kernel is in ``scan_probe_march.py`` (P1 the
transpose, P2 the march's top-2 crossing search, P3, P3b and P3c the
two-subtable and masked gathers) run through the probe's own
``pallas_call`` in Pallas interpret mode and through the port's wrapper (on
CPU tensors, its plain twin), on the same numpy inputs, and must agree bit
for bit. The probe's run functions (``p1``, ``p2_run``, ``p3_run``,
``p3x_run``) build their inputs and kernels and hand them to its ``probe``
helper; here that helper is replaced by one that keeps what it is given and
stops the run, so the probe's own inputs and trips=1 kernel are used and
none of its timing runs. P2 is also run at trips 4 through ``p2(trips)``,
and on inputs built for its top 2's corners, and P3's kernels at trips 3
through a ``pallas_call`` made as the probe's ``mk`` makes it, so that the
sums over trips are compared too.

P2's shift ``0.001 * t`` is a float32 product added to ``qx``: on an input
made so that the contracted form ``fma(0.001, t, qx)`` and the product-then-
sum form cross a column at trip 3 differently, JAX's output is the
product-then-sum one, which the twin and the kernel compute. With no
crossing a pixel's ``m1`` is 3e38, and over two trips it sums to inf in
JAX, the twin and the kernel alike.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from depthrenderer_tpu_torch import probes
from depthrenderer_tpu_torch.probes import march

from test_torch_probes_gather import EXPERIMENTS, bits, load_probe, port_output

CASES = probes.CASES
MARCH_CASES = [c for c in CASES.values()
               if c.site.startswith("experiments/scan_probe_march.py")]


class _Stop(Exception):
    pass


@pytest.fixture(autouse=True)
def tpu_interpret():
    """The probe's run functions build their ``pallas_call`` before they
    call it, so the whole test runs in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        yield


def probe_run(run, kernel=None):
    """Run one of the probe's run functions (``p3x_run`` with its kernel
    body) up to its first ``probe`` call; -> (module, (fn, inputs) that
    call was given)."""
    mod = load_probe("scan_probe_march")
    got = []

    def keep(name, fn, *ins):
        got.append((fn, ins))
        raise _Stop

    mod.probe = keep
    with pytest.raises(_Stop):
        getattr(mod, run)(*(() if kernel is None
                            else (getattr(mod, kernel), kernel)))
    return mod, got[0]


def interpret(fn, *ins):
    return np.asarray(jax.block_until_ready(fn(*ins)))


# case -> (run function, kernel body).
P3 = {"spm_p3_clip": ("p3_run", "gather_kernel"),
      "spm_p3b_and": ("p3x_run", "gather_kernel_b"),
      "spm_p3c_mask": ("p3x_run", "gather_kernel_c")}


def test_every_march_probe_site_has_a_case():
    src = (EXPERIMENTS / "scan_probe_march.py").read_text().splitlines()
    sites = {f"experiments/scan_probe_march.py:{n}"
             for n, line in enumerate(src, 1) if "pallas_call(" in line}
    assert len(sites) == 4
    assert sites == {c.site for c in MARCH_CASES}
    assert len(probes.CASES) == 40
    assert {c.kernel for c in probes.CASES.values()} == set(
        probes.KERNEL_NAMES)


def test_transpose_equals_jax_probe():
    case = CASES["spm_p1_transpose"]
    _, (fn, (x,)) = probe_run("p1")
    want = interpret(fn, x)
    got = port_output(case, (np.asarray(x),), 1)
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(want, np.asarray(x).T)


@pytest.mark.parametrize("trips", [1, 4])
def test_march_top2_equals_jax_probe(trips):
    case = CASES["spm_p2_march"]
    mod, (fn1, ins) = probe_run("p2_run")
    ins = [np.asarray(a) for a in ins]
    want = interpret(fn1 if trips == 1 else mod.p2(trips), *ins)
    got = port_output(case, ins, trips)
    assert got.shape == want.shape == case.out
    assert np.array_equal(bits(got), bits(want))
    # Pixels past the last crossing keep the no-hit key, 3e38 a trip.
    assert (np.isinf(want[1::4]) == (trips > 1)).any()


def test_march_shift_is_a_float32_product_then_sum():
    """An input on which fma(0.001, 3, q) and q + f32(0.001 * 3) cross a
    column differently at trip 3: JAX, and the twin, see no crossing."""
    case = CASES["spm_p2_march"]
    mod = load_probe("scan_probe_march")
    q0 = np.random.default_rng(3).uniform(-0.01, 0.01, 100000).astype(
        np.float32)
    summed = q0 + np.float32(np.float32(0.001) * np.float32(3))
    fused = (q0.astype(np.float64)
             + np.float64(np.float32(0.001)) * 3).astype(np.float32)
    k = int(np.flatnonzero(fused != summed)[0])
    qx = np.full((8, 128), q0[k], np.float32)
    curve = np.full((8, 256), 5.0, np.float32)
    curve[:, 100] = fused[k]
    zc = np.random.default_rng(4).uniform(-1, 1, (8, 256)).astype(np.float32)
    want = [interpret(mod.p2(t), curve, zc, qx) for t in (3, 4)]
    got = [port_output(case, (curve, zc, qx), t) for t in (3, 4)]
    for w, g in zip(want, got):
        assert np.array_equal(bits(g), bits(w))
    # Trip 3 adds column 0 (no crossing), as after trips 0-2.
    assert np.array_equal(want[1][0::4], want[0][0::4])


@pytest.mark.parametrize("name", march.EDGE_CASES)
def test_march_top2_edge_inputs_equal_jax_probe(name):
    """Inputs built for the top 2's corners (``march.edge_inputs``: tied
    depths, products of exactly 0, rows with no crossing, the hits at
    column 0 and at the wrap column C - 1) through the probe's P2 at trips
    1 and 5, bit for bit."""
    case = CASES["spm_p2_march"]
    mod = load_probe("scan_probe_march")
    ins = march.edge_inputs(name, seed=7)
    for trips in (1, 5):
        want = interpret(mod.p2(trips), *ins.values())
        got = port_output(case, list(ins.values()), trips)
        assert np.array_equal(bits(got), bits(want)), trips
    o1, m1, o2, m2 = (want[k::4] for k in range(4))
    if name == "no_crossing":
        assert (o1 == 0).all() and (o2 == 0).all() and np.isinf(m1).all()
    elif name == "wrap_pair":
        assert set(np.unique(np.concatenate([o1, o2]))) <= {0.0, 5 * 255.0}
    elif name == "tied_z":
        assert ((m1 == m2) & (o1 != o2)).any()


@pytest.mark.parametrize("name", sorted(P3))
def test_two_subtable_gathers_equal_jax_probe(name):
    case = CASES[name]
    run, body = P3[name]
    mod, (fn1, ins) = probe_run(run, None if run == "p3_run" else body)
    ins = [np.asarray(a) for a in ins]
    fn3 = jax.jit(pl.pallas_call(
        functools.partial(getattr(mod, body), trips=3),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM)))
    for trips, fn in ((1, fn1), (3, fn3)):
        want = interpret(fn, *ins)
        got = port_output(case, ins, trips)
        assert np.array_equal(bits(got), bits(want)), trips
