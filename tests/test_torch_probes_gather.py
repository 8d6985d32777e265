"""The port's gather probes against the JAX package's TPU gather probes.

Every case of ``depthrenderer_tpu_torch.probes`` whose TPU kernel lives in
``experiments/gather_probe*.py`` runs here twice on the same numpy inputs:
through the probe's own builder and ``pallas_call`` in Pallas interpret mode,
and through the port's wrapper, which on CPU tensors runs its plain twin.
The two must agree bit for bit (float32 compared as int32 bits, tolerance
0). Trip counts are cut to at most 4 (the module constant the probe reads,
``ITERS`` or ``OUTER``, is set before the kernel is traced); widths, unrolls
and dtypes are the probe's own. The probes draw their inputs from the
global ``np.random`` (seeded here per case) or from their own seeded
generators; the arrays the probe's build function returns are what the
twin gets.

The probe modules are loaded by :func:`load_probe`, which executes only
their imports, constant assignments and definitions: ``gather_probe10``
times itself at import and the probes set a compile cache in the
environment, and neither happens here.
"""

import ast
import types
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from depthrenderer_tpu_torch import probes

torch.set_num_threads(1)

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def load_probe(name: str) -> types.ModuleType:
    """``experiments/<name>.py`` with only its imports, constant assignments
    (no call on the right-hand side) and function and class definitions
    executed."""
    path = EXPERIMENTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    tree.body = [
        n for n in tree.body
        if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                          ast.ClassDef))
        or (isinstance(n, ast.Assign)
            and not any(isinstance(c, ast.Call) for c in ast.walk(n.value)))]
    mod = types.ModuleType(f"probe_{name}")
    mod.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def probe_module(case) -> str:
    return Path(case.site.split(":")[0]).stem


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def port_output(case, arrays, trips):
    """The port's wrapper on CPU tensors of ``arrays`` (the probe's own
    inputs, in the wrapper's argument order)."""
    keys = list(probes.make_inputs(case))
    ins = {k: torch.from_numpy(np.array(a).view(np.int32) if a.dtype ==
                               np.uint32 else np.array(a))
           for k, a in zip(keys, map(np.asarray, arrays))}
    return probes.run_case(case, ins, trips).numpy()


def _first(built):
    fn, sets = built
    return fn, sets[0]


# Each gather case's probe builder -> (fn, input arrays).
JAX_BUILD = {
    "gp1_lane": lambda m: m.build_lane_gather(),
    "gp1_sublane": lambda m: m.build_sublane_gather(),
    "gp1_flat": lambda m: m.build_flat_take(),
    "gp1_onehot": lambda m: m.build_onehot_mxu(),
    "gp2_a2": lambda m: m.build_a2(),
    "gp2_b2": lambda m: m.build_b2(),
    "gp2_b3": lambda m: m.build_b3(),
    "gp2_a3": lambda m: m.build_a3(),
    "gp2_rowsel": lambda m: m.build_rowsel(),
    "gp3_f32_s8": lambda m: m.build_gather(8)()[:2],
    "gp3_f32_s16": lambda m: m.build_gather(16)()[:2],
    "gp3_f32_s32": lambda m: m.build_gather(32)()[:2],
    "gp3_u32_s8": lambda m: m.build_gather(8, m.jnp.uint32)()[:2],
    "gp3_fma_s8": lambda m: m.build_baseline(8)()[:2],
    "gp4_mask_s8": lambda m: m.build_gather(8, MASK=True)()[:2],
    "gp4_mask_s16": lambda m: m.build_gather(16, MASK=True)()[:2],
    "gp4_mask_s32": lambda m: m.build_gather(32, MASK=True)()[:2],
    "gp4_fma_s8": lambda m: m.build_baseline(8)()[:2],
    "gp5_dense": lambda m: m.build_dense(False)(),
    "gp5_dense_mask": lambda m: m.build_dense(True)(),
    "gp5_multi": lambda m: m.build_dense_multi()(),
    "gp5_roll": lambda m: m.build_roll()(),
    "gp5_int": lambda m: m.build_int_gather()(),
    "gp5_bitcast": lambda m: m.build_bitcast()(),
    "gp8_convert": lambda m: _first(m.build(False)()),
    "gp8_gather": lambda m: _first(m.build(True)()),
    "gp9_convert": lambda m: _first(m.build(False)()),
    "gp9_gather": lambda m: _first(m.build(True)()),
}
for _p in (6, 7):
    JAX_BUILD.update({
        f"gp{_p}_fma": lambda m: _first(m.build_fma()()),
        f"gp{_p}_raw": lambda m: _first(m.build_gather(False)()),
        f"gp{_p}_mask": lambda m: _first(m.build_gather(True)())})


def cut_trips(case) -> int:
    """The trips a case runs at here: the probe's own check count for
    gather_probe10 (3), else 4, or 2 for the 32- and 64-set unrolls."""
    if case.name == "gp10_gather":
        return 3
    return 4 if case.unroll <= 8 else 2


def jax_probe(case, trips):
    """(output, inputs) of the case's TPU probe kernel in interpret mode."""
    mod = load_probe(probe_module(case))
    np.random.seed(zlib.crc32(case.name.encode()))
    if case.name == "gp10_gather":
        # The module's own inputs: default_rng(0), drawn as it draws them.
        rng = np.random.default_rng(0)
        tab = rng.random((8, 128)).astype(np.float32)
        idx = rng.integers(0, 128, (mod.UNROLL, 8, 128)).astype(np.int32)
        fn, args = mod.make_fn(trips), (tab, idx)
    else:
        if hasattr(mod, "ITERS"):
            mod.ITERS = trips * (8 if case.kernel == "onehot_dot" else 1)
        else:
            mod.OUTER = trips
        fn, args = JAX_BUILD[case.name](mod)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jax.block_until_ready(fn(*args)))
    return out, [np.asarray(a) for a in args]


GATHER_CASES = [c for c in probes.CASES.values()
                if probe_module(c).startswith("gather_probe")]


def test_every_gather_probe_site_has_a_case():
    sites = set()
    for path in sorted(EXPERIMENTS.glob("gather_probe*.py")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if "pallas_call(" in line:
                sites.add(f"experiments/{path.name}:{n}")
    assert len(sites) == 15
    assert sites == {c.site for c in GATHER_CASES}
    assert set(JAX_BUILD) | {"gp10_gather"} == {c.name for c in GATHER_CASES}


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: c.name)
def test_gather_twin_equals_jax_probe(case):
    trips = cut_trips(case)
    want, arrays = jax_probe(case, trips)
    got = port_output(case, arrays, trips)
    assert got.shape == want.shape == case.out
    assert np.array_equal(bits(got), bits(want))
    assert np.isfinite(want).all() and np.abs(want).max() > 0


def test_int_sum_wraps_as_xla_does():
    """gather_probe5's int32 table wraps its sum at the probe's own trips
    (4,096 adds of values below 2**20); here values above 2**29 wrap it
    within the cut trips, and the twin wraps as XLA does."""
    case = probes.CASES["gp5_int"]
    mod = load_probe("gather_probe5")
    mod.OUTER = 2
    np.random.seed(5)
    fn, (tab, idx) = mod.build_int_gather()()
    tab = np.asarray(tab) + np.int32(0x23456789)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.block_until_ready(fn(tab, idx)))
    got = port_output(case, (tab, idx), 2)
    assert np.array_equal(got, want)
    exact = 2 * np.take_along_axis(
        tab.astype(np.int64)[None], np.asarray(idx) & 127, axis=2).sum(0)
    assert (exact > 2**31).all() and (want != exact).all()
