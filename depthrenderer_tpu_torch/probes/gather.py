"""The gather probes: ``gather_accum``, ``roll_accum`` and ``onehot_dot``.

Counterparts of ``experiments/gather_probe.py`` ... ``gather_probe10.py``
and of ``scan_probe_march.py``'s P3, P3b and P3c (the cases of
:data:`~depthrenderer_tpu_torch.probes.CASES` whose kernel is one of these).
Each twin (``*_plain``) computes what the Pallas probe computes, in its
order: per trip ``i`` and index set ``u``, ``acc[u % naccs] += g(i, u)``,
then ``a0 + a1 + a2 + a3``; the kernels in ``csrc/probes.cu`` take the same
float32 steps, so the two are equal bit for bit.
"""

from __future__ import annotations

import torch

from .. import probes as _p
from ..ops import common, cuda_build

_F32, _I32 = torch.float32, torch.int32


def _sets(idx, case):
    """The case's index sets as (unroll-or-more, S, L) views (a (S, 1)
    row-select index broadcast over the lanes)."""
    s, l = case.out
    sets = idx.reshape((-1,) + tuple(idx.shape[-2:]))[:, :s, :l]
    return sets.expand(-1, s, l)


def _gathered(tabs, raw, i, u, case):
    """The value one lookup adds: table word at the case's index form, with
    its epilogue (u32 cast, i32 widened, low 16 bits of the f32 bits)."""
    s = case.out[0]
    form = case.form
    t = tabs[u % tabs.shape[0]]
    if form in ("clip2", "and2"):
        if form == "clip2":
            x = (raw + i).clamp(0, 255)
            lo, hi = x.clamp(0, 127), (x - 128).clamp(0, 127)
        else:
            x = (raw + i) & 255
            lo = hi = x & 127
        g0 = torch.gather(t[:s, :128], 1, lo.long())
        g1 = torch.gather(t[:s, 128:256], 1, hi.long())
        g = torch.where(x < 128, g0, g1)
    else:
        ix = {"static": raw, "mask": raw & case.mask,
              "addmask": (raw + i) & case.mask}[form].long()
        if case.axis == "lane":
            g = torch.gather(t[:s], 1, ix)
        elif case.axis == "sublane":
            g = torch.gather(t, 0, ix)
        else:
            g = t.reshape(-1)[ix]
    if case.dtype == "u32":
        return (g.long() & 0xFFFFFFFF).float()
    if case.dtype == "i32":
        return g.long()
    if case.dtype == "bitcast":
        return (g.view(_I32) & 0xFFFF).float()
    return g


def _copied(out, copies: int):
    return out if copies == 1 else out.expand(copies, *out.shape).contiguous()


def gather_accum_plain(tab, idx, case, trips: int, copies: int = 1):
    """Plain twin of the ``gather_accum`` kernel: (S, L) float32 (int32
    for an i32 table, whose sum wraps in two's complement); ``copies`` > 1
    stacks that many."""
    s, l = case.out
    tabs = tab.reshape((-1,) + tuple(tab.shape[-2:]))
    sets = _sets(idx, case)
    wide = case.dtype == "i32"
    accs = [torch.zeros((s, l), dtype=torch.int64 if wide else _F32,
                        device=tab.device) for _ in range(case.naccs)]
    for i in range(trips):
        for u in range(case.unroll):
            k, raw = u % case.naccs, sets[u]
            if case.form == "fma":
                # acc + t * x as XLA's CPU backend contracts it.
                accs[k] = common.fma(tabs[0][:s, :l], raw, accs[k])
            elif case.form == "convert":
                accs[k] = accs[k] + ((raw + i) & case.mask).float()
            else:
                accs[k] = accs[k] + _gathered(tabs, raw, i, u, case)
    r = accs[0]
    for a in accs[1:]:
        r = r + a
    if wide:
        r = ((r + 2**31) % 2**32 - 2**31).to(_I32)
    return _copied(r, copies)


def _tab_dtype(case):
    return _I32 if case.dtype in ("u32", "i32") else _F32


def gather_params(case, trips: int, copies: int = 1) -> _p.ProbeParams:
    """The kernel's parameters; raises ``ValueError`` where the case's
    index form could read outside the staged table. A ``static`` index is
    used as given and must lie in the gathered axis's range (the runner's
    inputs do; checking it here would wait for the device)."""
    s, l = case.out
    r, c = case.table[-2:]
    extent = {"lane": c, "sublane": r, "flat": r * c}[case.axis]
    if case.form in ("mask", "addmask") and case.mask >= extent:
        raise ValueError(f"{case.name}: mask {case.mask} reaches past the "
                         f"table's {extent} entries")
    if case.form in ("clip2", "and2") and c < 256:
        raise ValueError(f"{case.name}: two 128-column subtables need 256 "
                         f"columns, got {c}")
    si, li = case.index[-2:]
    bs, bl, _ = _p.geometry(case)
    return _p.ProbeParams(
        form=_p.FORMS[case.form], axis=_p.AXES[case.axis],
        dtype=_p.DTYPES[case.dtype], naccs=case.naccs, S=s, L=l,
        ntab=case.ntab, R=r, C=c, unroll=case.unroll,
        idx_us=si * li if len(case.index) == 3 else 0, idx_ss=li,
        idx_ls=1 if li > 1 else 0, mask=case.mask, trips=trips, bs=bs, bl=bl,
        copies=copies)


def _out_shape(case, copies: int):
    return case.out if copies == 1 else (copies,) + case.out


def gather_accum(tab, idx, case, trips: int, copies: int = 1):
    """Per output element, the sum over ``trips`` trips and ``case.unroll``
    index sets of the value the case's index form gathers from ``tab``
    (shapes ``case.table`` and ``case.index``; float32, or int32 holding a
    u32 or i32 table; the baselines' ``idx`` is float32) -> ``case.out``
    (``copies`` > 1: that many identical outputs, each its own blocks).

    CPU tensors: :func:`gather_accum_plain`; CUDA tensors: the
    ``gather_accum`` kernel (one launch), or an exception."""
    if _p.on_cpu(tab, idx):
        return gather_accum_plain(tab, idx, case, trips, copies)
    cuda_build.check_cuda(
        {"tab": tab, "idx": idx},
        {"tab": _tab_dtype(case),
         "idx": _F32 if case.form == "fma" else _I32},
        {"tab": case.table, "idx": case.index})
    out = torch.empty(_out_shape(case, copies),
                      dtype=_I32 if case.dtype == "i32" else _F32,
                      device=tab.device)
    _p.launch("gather_accum", (tab, idx, out),
              gather_params(case, trips, copies))
    return out


def roll_accum_plain(tab, sh, case, trips: int, copies: int = 1):
    """Plain twin of ``roll_accum``: sum over trips and shifts ``sh[u, 0]``
    of ``jnp.roll(tab, sh, axis=1)[:, :L]``."""
    s, l = case.out
    shifts = sh[:case.unroll, 0].tolist()
    acc = torch.zeros((s, l), dtype=_F32, device=tab.device)
    for _ in range(trips):
        for k in shifts:
            acc = acc + torch.roll(tab, k, dims=1)[:, :l]
    return _copied(acc, copies)


def roll_accum(tab, sh, case, trips: int, copies: int = 1):
    """``out[s, l] = sum over trips and u of tab[s, (l - sh[u, 0]) mod C]``
    (``jnp.roll``'s convention) -> ``case.out`` float32.

    CPU tensors: :func:`roll_accum_plain`; CUDA tensors: the ``roll_accum``
    kernel (one launch), or an exception."""
    if _p.on_cpu(tab, sh):
        return roll_accum_plain(tab, sh, case, trips, copies)
    cuda_build.check_cuda({"tab": tab, "sh": sh}, {"tab": _F32, "sh": _I32},
                          {"tab": case.table, "sh": case.index})
    s, l = case.out
    bs, bl, _ = _p.geometry(case)
    out = torch.empty(_out_shape(case, copies), dtype=_F32,
                      device=tab.device)
    params = _p.ProbeParams(S=s, L=l, ntab=1, R=case.table[0],
                            C=case.table[1], unroll=case.unroll, trips=trips,
                            bs=bs, bl=bl, copies=copies)
    _p.launch("roll_accum", (tab, sh, out), params)
    return out


def onehot_dot_plain(tab, idx, case, trips: int):
    """Plain twin of ``onehot_dot``: per trip ``onehot((idx + i) % R) @
    tab`` added to the sum. The product is taken in float64, where a
    one-hot row picks its value exactly on any device and under any
    float32 matmul precision setting."""
    cells = torch.arange(tab.shape[0], device=tab.device)
    acc = torch.zeros(case.out, dtype=_F32, device=tab.device)
    for i in range(trips):
        oh = (cells[None, :] == (idx + i) % tab.shape[0]).double()
        acc = acc + (oh @ tab.double()).float()
    return acc


def onehot_dot(tab, idx, case, trips: int):
    """Per trip, the one-hot contraction ``onehot((idx + i) % R) @ tab``
    over the R cells of ``tab`` (R, W), summed over the trips -> (P, W)
    float32. The kernel does the dense multiply-adds; a one-hot row makes
    every sum exact.

    CPU tensors: :func:`onehot_dot_plain`; CUDA tensors: the ``onehot_dot``
    kernel (one launch), or an exception."""
    if _p.on_cpu(tab, idx):
        return onehot_dot_plain(tab, idx, case, trips)
    cuda_build.check_cuda({"tab": tab, "idx": idx},
                          {"tab": _F32, "idx": _I32},
                          {"tab": case.table, "idx": case.index})
    out = torch.empty(case.out, dtype=_F32, device=tab.device)
    params = _p.ProbeParams(S=case.out[0], L=case.out[1], R=case.table[0],
                            C=case.table[1], trips=trips)
    _p.launch("onehot_dot", (tab, idx, out), params)
    return out
