"""Hopper micro-benchmarks of on-chip gathers and of the march's core: the
counterparts of the TPU probe kernels in ``experiments/``.

The JAX package's scan kernel was shaped by questions asked of the TPU with
small Pallas probes (``experiments/gather_probe.py`` ... ``gather_probe10.py``
and ``experiments/scan_probe_march.py``): what a per-element dynamic gather
from an on-chip table costs in every form (lane, sublane, flat, one-hot
contraction, two-subtable, roll), and how fast the march's dense sign test
with a top-2 by depth runs. This package asks the H100 the same questions.

Every probe builder is one :class:`Case` in :data:`CASES`: its
``pallas_call`` site, its shapes, dtype and index form, its unroll,
accumulators and epilogue, and the probe's own trip counts. Five
hand-written CUDA kernels (``csrc/probes.cu``, built by
:mod:`depthrenderer_tpu_torch.ops.cuda_build` at first use) cover all of
them, each with a plain PyTorch twin that computes the same float32
operations in the same order:

* ``gather_accum`` (:mod:`.gather`): every gather probe and
  ``scan_probe_march`` P3, P3b, P3c, and the baselines without a gather;
* ``roll_accum`` (:mod:`.gather`): ``gather_probe5.build_roll``;
* ``onehot_dot`` (:mod:`.gather`): ``gather_probe.build_onehot_mxu``;
* ``transpose`` (:mod:`.march`): ``scan_probe_march`` P1;
* ``march_top2`` (:mod:`.march`): ``scan_probe_march`` P2.

A wrapper runs its twin when every tensor lies on the CPU and otherwise
launches its kernel, or raises (``cuda_build``'s rule). Run them all with
``python -m depthrenderer_tpu_torch.probes`` (see :mod:`.__main__`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np

from ..ops import cuda_build

KERNEL_NAMES = ("gather_accum", "roll_accum", "onehot_dot", "transpose",
                "march_top2")

# Codes of ProbeParams.form / .axis / .dtype (enums Form, Axis, Dtype in
# csrc/probes.cu).
FORMS = {"static": 0, "mask": 1, "addmask": 2, "clip2": 3, "and2": 4,
         "fma": 5, "convert": 6}
AXES = {"lane": 0, "sublane": 1, "flat": 2}
DTYPES = {"f32": 0, "u32": 1, "i32": 2, "bitcast": 3}


@dataclasses.dataclass(frozen=True)
class Case:
    """One probe builder and the kernel that stands for it.

    ``site`` is the probe's ``pl.pallas_call`` (file:line) and ``builder``
    the function that builds it. ``trips`` are the probe's own trip counts;
    ``slope`` the two the runner times (the probe's pair, or its one count
    and four times it), ``quick`` the smoke's pair where it skips a long
    count. Gather geometry: table (``ntab`` tables of R x C as the probe
    builds it, ``table``), index sets ``index`` drawn from ``[0,
    index_high)``, output ``out``; ``form`` is the index form (``static``
    idx, ``mask`` idx & mask, ``addmask`` (idx + i) & mask, which equals
    the probes' (idx + i) % n for n = mask + 1, ``clip2`` and ``and2`` the
    two-subtable forms, ``fma`` and ``convert`` the baselines without a
    gather), ``axis`` lane (table[s, ix]), sublane (table[ix, l]) or flat,
    ``unroll`` index sets per trip, ``naccs`` rotating accumulators (4:
    summed a0 + a1 + a2 + a3 at the end). ``dtype`` sets the epilogue: f32
    none, u32 a cast to f32, i32 a wrapping int32 sum, bitcast the low 16
    bits of the f32 word as f32.
    """

    name: str
    kernel: str
    site: str
    builder: str
    trips: tuple
    out: tuple
    table: tuple = ()
    index: tuple = ()
    index_high: int = 0
    dtype: str = "f32"
    axis: str = "lane"
    form: str = "static"
    mask: int = 0
    unroll: int = 1
    naccs: int = 1
    slope: tuple = ()
    quick: tuple = ()

    @property
    def ntab(self) -> int:
        return self.table[0] if len(self.table) == 3 else 1


def _g(name, site, builder, trips, out, table, index, index_high, form,
       **kw):
    t = trips[0]
    kw.setdefault("slope", (t, 4 * t))
    return Case(name, "gather_accum", site, builder, trips, out, table,
                index, index_high, form=form, **kw)


_GP, _SPM = "experiments/gather_probe", "experiments/scan_probe_march.py"
_LANE = dict(out=(128, 128), index=(128, 128))
_CASES = [
    # gather_probe.py: ITERS = 256 trips, (128, 128) outputs.
    _g("gp1_lane", f"{_GP}.py:70", "build_lane_gather l.58", (256,),
       table=(128, 512), index_high=512, form="addmask", mask=511, **_LANE),
    _g("gp1_sublane", f"{_GP}.py:93", "build_sublane_gather l.81", (256,),
       table=(512, 128), index_high=512, form="addmask", mask=511,
       axis="sublane", **_LANE),
    _g("gp1_flat", f"{_GP}.py:117", "build_flat_take l.104", (256,),
       table=(8, 2048), index_high=16384, form="addmask", mask=16383,
       axis="flat", **_LANE),
    Case("gp1_onehot", "onehot_dot", f"{_GP}.py:149", "build_onehot_mxu "
         "l.128", (32,), out=(1024, 8), table=(1536, 8), index=(1024, 1),
         index_high=1536, slope=(32, 128)),
    # gather_probe2.py: make() l.42, ITERS = 256.
    _g("gp2_a2", f"{_GP}2.py:44", "build_a2 l.54", (256,),
       table=(128, 128), index_high=128, form="addmask", mask=127, **_LANE),
    _g("gp2_b2", f"{_GP}2.py:44", "build_b2 l.67", (256,),
       table=(128, 128), index_high=128, form="addmask", mask=127,
       axis="sublane", **_LANE),
    _g("gp2_b3", f"{_GP}2.py:44", "build_b3 l.82", (256,), out=(128, 128),
       table=(512, 128), index=(512, 128), index_high=512, form="addmask",
       mask=511, axis="sublane"),
    _g("gp2_a3", f"{_GP}2.py:44", "build_a3 l.95", (256,), out=(128, 128),
       table=(128, 512), index=(128, 512), index_high=512, form="addmask",
       mask=511),
    _g("gp2_rowsel", f"{_GP}2.py:44", "build_rowsel l.110", (256,),
       out=(128, 128), table=(512, 128), index=(128, 1), index_high=512,
       form="addmask", mask=511, axis="sublane"),
]
# gather_probe3.py / gather_probe4.py: OUTER = 512 trips of UNROLL = 8
# static index sets out of NIDX = 16.
for _s in (8, 16, 32):
    _CASES.append(_g(f"gp3_f32_s{_s}", f"{_GP}3.py:68", f"build_gather({_s}) "
                     "l.47", (512,), out=(_s, 128), table=(_s, 128),
                     index=(16, _s, 128), index_high=128, form="static",
                     unroll=8))
_CASES += [
    _g("gp3_u32_s8", f"{_GP}3.py:68", "build_gather(8, jnp.uint32) l.47",
       (512,), out=(8, 128), table=(8, 128), index=(16, 8, 128),
       index_high=128, form="static", unroll=8, dtype="u32"),
    _g("gp3_fma_s8", f"{_GP}3.py:94", "build_baseline(8) l.78", (512,),
       out=(8, 128), table=(8, 128), index=(16, 8, 128), index_high=0,
       form="fma", unroll=8),
]
for _s in (8, 16, 32):
    _CASES.append(_g(f"gp4_mask_s{_s}", f"{_GP}4.py:69",
                     f"build_gather({_s}, MASK=True) l.47", (512,),
                     out=(_s, 128), table=(_s, 128), index=(16, _s, 128),
                     index_high=128, form="mask", mask=127, unroll=8))
_CASES.append(_g("gp4_fma_s8", f"{_GP}4.py:95", "build_baseline(8) l.79",
                 (512,), out=(8, 128), table=(8, 128), index=(16, 8, 128),
                 index_high=0, form="fma", unroll=8))
# gather_probe5.py: make() l.42, OUTER = 64 trips of UNROLL = 64 sets.
_D5 = dict(out=(8, 128), index=(64, 8, 128), index_high=128, unroll=64)
_CASES += [
    _g("gp5_dense", f"{_GP}5.py:44", "build_dense(False) l.54", (64,),
       table=(8, 128), form="static", **_D5),
    _g("gp5_dense_mask", f"{_GP}5.py:44", "build_dense(True) l.54", (64,),
       table=(8, 128), form="mask", mask=127, **_D5),
    _g("gp5_multi", f"{_GP}5.py:44", "build_dense_multi l.76", (64,),
       table=(8, 8, 128), form="mask", mask=127, **_D5),
    Case("gp5_roll", "roll_accum", f"{_GP}5.py:44", "build_roll l.96",
         (64,), out=(8, 128), table=(8, 256), index=(64, 1), index_high=256,
         unroll=64, slope=(64, 256)),
    _g("gp5_int", f"{_GP}5.py:44", "build_int_gather l.116", (64,),
       table=(8, 128), form="mask", mask=127, dtype="i32", **_D5),
    _g("gp5_bitcast", f"{_GP}5.py:44", "build_bitcast l.136", (64,),
       table=(8, 128), form="mask", mask=127, dtype="bitcast", **_D5),
]
# gather_probe6.py (OUTER = 512) / gather_probe7.py (OUTER = 8192): pc() l.51,
# UNROLL = 64 sets.
for _p, _outer in ((6, 512), (7, 8192)):
    _site = f"{_GP}{_p}.py:53"
    _CASES += [
        _g(f"gp{_p}_fma", _site, "build_fma l.86", (_outer,), table=(8, 128),
           form="fma", **dict(_D5, index_high=0)),
        _g(f"gp{_p}_raw", _site, "build_gather(False) l.62", (_outer,),
           table=(8, 128), form="static", **_D5),
        _g(f"gp{_p}_mask", _site, "build_gather(True) l.62", (_outer,),
           table=(8, 128), form="mask", mask=127, **_D5),
    ]
# gather_probe8.py (OUTER = 2048) / gather_probe9.py (OUTER = 65536): pc()
# l.47, UNROLL = 32 loop-variant (idx + i) & 127 sets into 4 accumulators.
_D8 = dict(out=(8, 128), table=(8, 128), index=(32, 8, 128), index_high=128,
           mask=127, unroll=32, naccs=4)
for _p, _outer, _quick in ((8, 2048, ()), (9, 65536, (2048, 8192))):
    _site = f"{_GP}{_p}.py:49"
    _CASES += [
        _g(f"gp{_p}_convert", _site, "build(False) l.68", (_outer,),
           form="convert", quick=_quick, **_D8),
        _g(f"gp{_p}_gather", _site, "build(True) l.68", (_outer,),
           form="addmask", quick=_quick, **_D8),
    ]
_CASES += [
    # gather_probe10.py: make_fn(outer) l.18 at its check count 3 and its
    # timed counts.
    _g("gp10_gather", f"{_GP}10.py:36", "make_fn(outer) l.18",
       (3, 1024, 8192, 65536), form="addmask", slope=(1024, 65536),
       quick=(1024, 8192), **_D8),
    # scan_probe_march.py.
    Case("spm_p1_transpose", "transpose", f"{_SPM}:45", "p1 "
         "(transpose_kernel l.39)", (1,), out=(256, 8), table=(8, 256),
         slope=(1, 1)),
    Case("spm_p2_march", "march_top2", f"{_SPM}:90", "p2(trips) "
         "(march_kernel l.58)", (1, 50, 250), out=(32, 128), table=(8, 256),
         index=(8, 128), slope=(50, 250)),
    _g("spm_p3_clip", f"{_SPM}:207", "p3_run.mk (gather_kernel l.133)",
       (1, 200, 1000), out=(8, 128), table=(8, 256), index=(8, 128),
       index_high=255, form="clip2", slope=(200, 1000)),
    _g("spm_p3b_and", f"{_SPM}:179", "p3x_run.mk (gather_kernel_b l.149)",
       (1, 1000, 5000), out=(8, 128), table=(8, 256), index=(8, 128),
       index_high=255, form="and2", slope=(1000, 5000)),
    _g("spm_p3c_mask", f"{_SPM}:179", "p3x_run.mk (gather_kernel_c l.163)",
       (1, 1000, 5000), out=(8, 128), table=(8, 256), index=(8, 128),
       index_high=255, form="addmask", mask=127, slope=(1000, 5000)),
]

CASES = {c.name: c for c in _CASES}


def cases_of(kernel: str):
    return [c for c in CASES.values() if c.kernel == kernel]


# ---------------------------------------------------------------------------
# Launch geometry, trip counts, inputs and work
# ---------------------------------------------------------------------------

def geometry(case: Case):
    """(bs, bl, blocks): output rows and columns per block and the block
    count. A lane gather (and a baseline, and the roll) gives a block one
    output row of 128 pixels, staging that row of each table; a sublane
    gather 8 rows x 32 columns, staging all table rows of its 32 columns
    (64 KB at 512 rows); the flat gather one row, staging the whole table.
    onehot_dot: 8 output rows a block (8 warps, each an eighth of the
    cells); march_top2: one row y a block; transpose: a 32 x 32 tile of
    the input a block."""
    s, l = case.out
    if case.kernel == "onehot_dot":
        return 8, 1, s // 8
    if case.kernel == "march_top2":
        return 1, l, case.table[0]
    if case.kernel == "transpose":
        r, c = case.table
        return 32, 32, -(-r // 32) * -(-c // 32)
    bs, bl = (8, 32) if case.axis == "sublane" else (1, l)
    return bs, bl, (s // bs) * (l // bl)


def sms_used(case: Case, n_sms: int = 132, copies: int = 1) -> int:
    return min(geometry(case)[2] * copies, n_sms)


# The most shared memory a gather_accum block stages: 64 KB leaves room for
# three blocks on an SM.
STAGE_BYTES = 64 * 1024


def stripe(case: Case) -> int:
    """log2 of the word stride of gather_accum's staged table (ProbeParams
    ``lg_stripe``): a lane gather stages its row of every table with each
    word as that many copies side by side, the most (up to 32) that fit in
    :data:`STAGE_BYTES`, so that lane j reads copy j and, with 32, no two
    lanes share a bank; a sublane gather's staged 32 columns are the same
    layout (5); the flat table is staged once (0)."""
    if case.axis == "sublane":
        return 5
    if case.axis == "flat":
        return 0
    lg = 5
    while (case.ntab * case.table[-1] * 4) << lg > STAGE_BYTES:
        lg -= 1
    return lg


def staged_words(case: Case, sets):
    """The staged table's word each lookup of trip 0 reads, (sets, S, L)
    int64 (the two-subtable forms: (2 * sets, S, L), the low then the high
    word), under gather_accum's layout (:func:`stripe`). ``sets`` are the
    case's index sets as the kernel reads them, (unroll, S, L)."""
    lg = stripe(case)
    x = np.asarray(sets, dtype=np.int64)
    if case.form in ("mask", "addmask"):
        x = x & case.mask
    elif case.form == "clip2":
        x = np.clip(x, 0, 255)
        x = np.concatenate([np.clip(x, 0, 127),
                            128 + np.clip(x - 128, 0, 127)])
    elif case.form == "and2":
        x = np.concatenate([x & 127, 128 + (x & 127)])
    lane = np.arange(case.out[1])
    if case.axis == "sublane":
        return x * 32 + lane % 32
    if case.axis == "flat":
        return x
    u = np.arange(len(x)) % case.unroll
    tab = (u % case.ntab)[:, None, None] * case.table[-1]
    return ((tab + x) << lg) + (lane & ((1 << lg) - 1))


def wavefronts(case: Case, inputs: dict) -> float:
    """Shared-memory wavefronts a warp's load takes on average under
    gather_accum's layout for these inputs (1.0: no bank conflict): per
    warp and load, the most distinct words any one of the 32 banks is asked
    for. Counted at trip 0; a (idx + i) & mask index shifts every lane's
    word by the same i, modulo the masked range, which keeps the count (the
    two-subtable forms are conflict-free by their 32 copies at any trip)."""
    if case.kernel != "gather_accum" or case.form in ("fma", "convert"):
        return 1.0
    s, l = case.out
    idx = np.asarray(inputs["idx"])
    sets = idx.reshape((-1,) + idx.shape[-2:])[:case.unroll, :s, :l]
    words = np.broadcast_to(staged_words(case, sets), (
        len(sets) * (2 if case.form in ("clip2", "and2") else 1), s, l))
    warps = words.reshape(-1, 32)
    total = 0
    for w in warps:
        w = np.unique(w)
        total += np.bincount(w % 32, minlength=32).max()
    return total / len(warps)


def check_trips(case: Case) -> int:
    """Trips at which the kernel is held against its twin: the shorter
    timed count, cut so that the twin takes at most ~2,048 steps."""
    return min(case.slope[0], max(1, 2048 // case.unroll))


def timing_trips(case: Case, quick: bool = False):
    """The two trip counts the runner times (quick: the smoke's)."""
    return case.quick if quick and case.quick else case.slope


def lookups_per_trip(case: Case) -> int:
    """Values fetched per trip (gathers, roll, baselines: outputs x index
    sets; onehot_dot: rows x values a row; march_top2: (row, pixel)
    sweeps; transpose: elements)."""
    s, l = case.out
    if case.kernel == "march_top2":
        return case.table[0] * case.index[1]
    return s * l * case.unroll


# Dense multiply-adds a clock per SM of an H100: FP32 on the CUDA cores; bf16
# on the tensor cores (989 TFLOP/s over 132 SMs at a 1.83 GHz clock).
FP32_MACS_PER_CLOCK = 128
BF16_TENSOR_MACS_PER_CLOCK = 2048
# onehot_dot's bf16 parts of each float32 table value (csrc/probes.cu).
ONEHOT_PARTS = 3


def onehot_macs(case: Case) -> int:
    """Multiply-adds of one trip's one-hot product: rows x cells x values."""
    return case.out[0] * case.table[0] * case.out[1]


def bound_work(case: Case):
    """(units a trip, units a clock per SM, what bounds it): shared-memory
    words at 32 a clock per SM for a gather and the roll (the gathered
    table words: two for the two-subtable forms); onehot_dot's multiply-adds
    on its three bf16 parts at the tensor cores' bf16 rate
    (``tensor_bf16``; :func:`onehot_macs` at FP32's rate is the row's FP32
    figure); FP32 multiply-adds at 128 a clock per SM for the baselines
    (march_top2: a subtract and a multiply per (row, pixel, column)); the
    transpose is bound by device memory (``None``)."""
    n = lookups_per_trip(case)
    if case.kernel == "transpose":
        return 2 * 4 * int(np.prod(case.table)), None, "bytes"
    if case.kernel == "onehot_dot":
        return (ONEHOT_PARTS * onehot_macs(case), BF16_TENSOR_MACS_PER_CLOCK,
                "tensor_bf16")
    if case.kernel == "march_top2":
        return 2 * n * case.table[1], FP32_MACS_PER_CLOCK, "fp32"
    if case.form in ("fma", "convert"):
        return n, FP32_MACS_PER_CLOCK, "fp32"
    return (2 if case.form in ("clip2", "and2") else 1) * n, 32, "smem"


# Kernels that compute ``copies`` identical outputs when asked to.
COPIED = ("gather_accum", "roll_accum", "onehot_dot", "march_top2")

# Index orders: the probe's (uniform in [0, index_high)), or ``lanes``: set
# u's index at (s, l) is l (mod index_high), so the 32 lanes of a warp read
# 32 neighbouring table words (no shared-memory bank conflict).
ORDERS = ("random", "lanes")


def make_inputs(case: Case, seed: int = 0, order: str = "random") -> dict:
    """The case's inputs as numpy arrays, drawn as its probe draws them
    (uniform [0, 1) tables, indices uniform in [0, index_high)), from
    ``seed``; ``order="lanes"`` replaces a gather's indices (see
    :data:`ORDERS`). Keys are the wrapper's argument names."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if case.kernel == "transpose":
        n = int(np.prod(case.table))
        return {"x": np.arange(n, dtype=f32).reshape(case.table)}
    if case.kernel == "march_top2":
        y, c = case.table
        qx = (np.arange(case.index[1]) * 15.0 + 0.5).astype(f32)
        return {"curve": np.sort(rng.uniform(0, 1920, (y, c)).astype(f32),
                                 axis=1),
                "zc": rng.uniform(-1, 1, (y, c)).astype(f32),
                "qx": np.broadcast_to(qx, case.index).copy()}
    if case.dtype == "i32":
        tab = rng.integers(0, 1 << 20, case.table).astype(np.int32)
    elif case.dtype == "u32":
        tab = (rng.random(case.table).astype(f32) * f32(1e6)).astype(
            np.uint32).view(np.int32)
    else:
        tab = rng.random(case.table).astype(f32)
    if case.form == "fma":
        idx = rng.random(case.index).astype(f32)
    else:
        idx = rng.integers(0, case.index_high, case.index).astype(np.int32)
        if order == "lanes" and case.kernel == "gather_accum":
            lanes = np.arange(case.index[-1]) % case.index_high
            idx = np.ascontiguousarray(np.broadcast_to(lanes, case.index),
                                       dtype=np.int32)
    key = "sh" if case.kernel == "roll_accum" else "idx"
    return {"tab": tab, key: idx}


def run_case(case: Case, inputs: dict, trips: int, plain: bool = False,
             copies: int = 1):
    """The case's wrapper (or, ``plain``, its twin) on ``inputs``
    (tensors keyed as :func:`make_inputs` keys them) at ``trips``;
    ``copies`` > 1 (the :data:`COPIED` kernels) computes that many
    identical outputs, (copies,) + ``case.out``."""
    from . import gather, march

    fns = {"gather_accum": (gather.gather_accum, gather.gather_accum_plain),
           "roll_accum": (gather.roll_accum, gather.roll_accum_plain),
           "onehot_dot": (gather.onehot_dot, gather.onehot_dot_plain),
           "transpose": (march.transpose, march.transpose_plain),
           "march_top2": (march.march_top2, march.march_top2_plain)}
    fn = fns[case.kernel][int(plain)]
    if case.kernel == "transpose":
        return fn(inputs["x"])
    if case.kernel in COPIED:
        return fn(*inputs.values(), case, trips, copies=copies)
    if copies != 1:
        raise ValueError(f"{case.kernel} computes one output")
    return fn(*inputs.values(), case, trips)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/probes.cu), built with nvcc on first use
# ---------------------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()

# Launches of each kernel since the last reset_launch_counts(); a wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {k: 0 for k in KERNEL_NAMES}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_kernels(force: bool = False):
    """Compile csrc/probes.cu into build/libprobes.so (nvcc, sm_90a) unless
    an up-to-date library exists. Raises ``RuntimeError`` with nvcc's
    output."""
    return cuda_build.build("probes.cu", force=force)


class ProbeParams(ctypes.Structure):
    """Mirror of ``struct ProbeParams`` in csrc/probes.cu (field order and
    types must match)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "form", "axis", "dtype", "naccs", "S", "L", "ntab", "R", "C",
        "unroll", "idx_us", "idx_ss", "idx_ls", "mask", "trips", "bs", "bl",
        "copies", "lg_stripe")]


# Pointer arguments of each C entry point (then the params and the stream).
_ENTRY = {"gather_accum": ("probe_gather_accum", 3),
          "roll_accum": ("probe_roll_accum", 3),
          "onehot_dot": ("probe_onehot_dot", 3),
          "transpose": ("probe_transpose", 2),
          "march_top2": ("probe_march_top2", 4)}


def bind(lib):
    """Set the C entry points' argument and result types on ``lib``."""
    vp = ctypes.c_void_p
    for name, n_ptr in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [ctypes.POINTER(ProbeParams), vp]
    lib.probe_error_string.restype = ctypes.c_char_p
    lib.probe_error_string.argtypes = [ctypes.c_int]
    return lib


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build_kernels())))
    return _lib


def on_cpu(*tensors) -> bool:
    return cuda_build.on_cpu(*tensors)


def launch(kernel: str, tensors, params: ProbeParams):
    """Launch ``kernel`` on the current stream of its tensors' device with
    these pointer arguments (inputs, then the output), raise on a failed
    launch, and count it."""
    import torch

    lib = _load_lib()
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    entry, _ = _ENTRY[kernel]
    err = getattr(lib, entry)(*[ctypes.c_void_p(t.data_ptr())
                                for t in tensors],
                              ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.probe_error_string(err).decode()}")
    LAUNCHES[kernel] += 1
