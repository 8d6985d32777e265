"""The scan's march, solve and shade kernels and the tiled routes' pair
kernel on one card: times case by case beside the bound, and ptxas's
registers and spills per kernel instance.

    python -m depthrenderer_tpu_torch.march_times [--beside PATH]
        [--beside-pair PATH] [--kernels march solve shade pairs]
        [--cases NAME ...] [--check] [--reps N] [--json PATH]

Builds ``csrc/scan.cu`` and prints ptxas's report of every
``march_kernel`` instance and of ``solve_kernel``, then times
``raster_scan.march_exact`` and ``raster_scan.solve_records`` with CUDA
events on seeded synthetic scenes (:mod:`.synthetic`), one line per kernel
and case:

- ``d10``: 1080p/d10, the default config, sway frame 0 (the main path's
  march); ``d10_colfix_none``, ``d10_hyps2``: the same records marched
  without the colfix fan, or with the second hypothesis; ``d10_wide``:
  every narrow block marched wide (the sweep over 256 instead of 128
  columns); ``d10_skip``: every block gated off (the slot gates and the
  attribute writes alone); ``d10_cull``, ``d10_wire``: the edge cull at
  0.25 and the wireframe coverage (their own instances).
- ``quality1``, ``quality2``, ``patch1``, ``patch2``: both passes of the
  two fidelity tiers at sway frame 74 (the patch tier's pass 2 sparse,
  gated by pass 1's holes).
- ``d11``: 1080p/d11 with edge cull 0.25 (big_grid's 640-column chunked
  march), frame 74; ``p4``: BASELINE preset 4 (4K/d12, edge cull 0.25, a
  1024-column chunked march), frame 0; each also ``_colfix_none``.

The solve and the shade are timed on the cases whose records differ
(:data:`SOLVE_CASES`: ``d10``, the tiers' four passes, ``d11``, ``p4``);
the shade on the march kernel's attrs, as the render loop meets them, by
the slope between CUDA graphs of 20 and 40 launches (a launch's device
time without the host's wrapper and launch cost), beside the same slope of
``F.grid_sample`` (bilinear, border, ``align_corners=False``) on a float
(1, 4, Ht, Wt) texture at the grid (2u - 1, 1 - 2v) of the same attrs: the
one PyTorch call that computes the same sample (``library_ms``; the port
never calls it). The pair kernel (:data:`PAIR_CASES`): ``tiled``, the
tiled CLI run's config at 1080p/d10 (``render.tiled_config`` over its 32
views) on its first :data:`PAIR_FRAMES` frames, through the Pallas route's
prep, and ``grid``, the same frames and config through the grid route's;
ptxas's report of ``pair_kernel``. ``--beside`` builds
another ``scan.cu`` with the same C interface too, say a parent commit's
(into ``build/beside/``), and times its kernels on the same inputs, in
turns with the package's (other, this, this, other; ``beside_ms`` beside
``ms``, each the mean of its two runs), so two versions compare in one
process on one card.

``--check`` also holds each case's attributes against the plain twin
(``march_exact_plain``, max abs 0) but preset 4's (the smoke checks six of
its bands), and each solve case's records against ``solve_records_plain``
(bit for bit, on the bands a pass renders). The bound is the larger of the
bytes a kernel must move over the card's memory rate and its operations
over the FP32 rate (:func:`scan_bounds`; the march: two comparisons per
pixel per swept record column; :func:`pair_bounds`). ``--beside-pair``
builds another ``pair.cu`` and times it in turns with the package's kernel
on the same frames: one of the package's interface (it exports
``pair_threads``) on the same plane tables, or one of the gathered-window
interface (``pair_raster`` on per-tile ``(chunks, 12, TC)`` window copies:
the kernel before it read the tables in place) on the windows gathered
out of them. ``--check``
holds the pair kernel's rows against the twin on every tile of the case.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM: HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM: float32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM: bf16 on the tensor cores, dense
CASES = ("d10", "d10_colfix_none", "d10_hyps2", "d10_wide", "d10_skip",
         "d10_cull", "d10_wire", "quality1", "quality2", "patch1", "patch2",
         "d11", "d11_colfix_none", "p4", "p4_colfix_none")
SOLVE_CASES = ("d10", "quality1", "quality2", "patch1", "patch2", "d11",
               "p4")
KERNELS = ("march", "solve", "shade", "pairs")
PAIR_CASES = ("tiled", "grid")
PAIR_FRAMES = 4
# FP32 operations per active (pixel, triangle) pair of the pair kernel, the
# least the function needs: the three λ planes at fma (2) + add (1), the
# qy*B products shared by a pixel row, and their three sign tests. The z
# plane and its tests are needed only for the pairs inside their triangle
# (a pixel lies in few of a window's triangles) and are left out, so the
# bound stays a lower bound.
PAIR_OPS = 12


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by): the card's least time for this work (the
    operations at ``ops_per_s``: float32 unless told otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def scan_bounds(prep, i, g, cfg, texq, bflag=None, with_z=False,
                min_lam=False):
    """Bytes and operations of the three scan kernels on frame i; with a
    band flag (sparse bands) the records, the window and the attributes
    read count only the flagged bands' share. The attributes are 4 planes;
    ``with_z`` (the tiers' passes): the march also writes the raster-z
    plane, and the shade reads it and writes the raster z; ``min_lam``
    (the quality wireframe's passes): the march writes a sixth plane too.
    A big_grid block sweeps its whole 128-aligned fetch window (``min(cw +
    128, CL)`` columns)."""
    from .ops import raster_scan as rs

    share = 1.0 if bflag is None else float(bflag.float().mean())
    rec = g.nbands * cfg.nbr * cfg.nrec * 8 * g.cl * 4 * share
    attrs = rs.n_attrs(with_z) * g.hpad * g.wl * 4
    march_attrs = rs.n_attrs(with_z, min_lam) * g.hpad * g.wl * 4
    ints = _nbytes(prep.w0[i], prep.bounds[i])
    win = _nbytes(prep.win[i]) * share
    solve = (win + ints + rec, 2 * 8 * 128 * g.nchunks * g.nbands * share)
    # The march sweeps, per pixel, the slot-0 record columns of its block's
    # march window (128 narrow, cw wide, none when skipped): two comparisons
    # each. The exact tests and colfix come on top, uncounted.
    mid = prep.mid[i].long()
    wide = min(cfg.cw + 128, g.cl) if cfg.big_grid else cfg.cw
    cols = torch.where(mid >= 0, 128, torch.where(mid == -1, wide, 0))
    if bflag is not None:
        cols = cols.reshape(g.nbands, g.nblk) * bflag.long()[:, None]
    march = (rec + win + _nbytes(prep.canch[i], prep.mid[i]) + ints
             + march_attrs, 2 * 1024 * int(cols.sum()))
    shade = (attrs * share + _nbytes(texq)
             + g.hpad * g.wl * 4 * (2 if with_z else 1), 0)
    return {"solve": solve, "march": march, "shade": shade}


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches (CUDA events), after one
    launch outside the timing."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scene(density, width, height):
    """The smoke's scene at this density and output size -> (mesh,
    projection, vertex grid, texture), grid and texture on the card."""
    from .scene import Camera, Mesh, Texture
    from .synthetic import synthetic_scene

    colour, depth = (synthetic_scene() if width <= 1920
                     else synthetic_scene(h=height, w=width))
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                             density=density)
    mesh.vertices[:, 2] *= 4.0
    n = int(round(len(mesh.vertices) ** 0.5))
    projection = Camera((colour.shape[1], colour.shape[0]),
                        fov_y=18.0).projection
    return (mesh, projection, mesh.vertices.reshape(n, n, 3).cuda(),
            mesh.texture.image.cuda())


def frame_mvp(mesh, projection, frame):
    """The MVP of one frame of the default 300-frame sway at 60 fps."""
    from . import animation, transforms
    from .render import clip_mvps

    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)))
    return clip_mvps(projection, views[frame:frame + 1], mesh.transform)


class Pass:
    """One frame's march inputs for a config: the prep, the kernel's
    records and :func:`raster_scan.march_exact`'s arguments."""

    def __init__(self, cfg, mvp, vgrid, texture, width, height, gates=None,
                 mid=None):
        from .ops import raster_scan as rs

        self.cfg = cfg
        self.g = g = rs.ScanGeometry.of(width, height, vgrid.shape[0],
                                        vgrid.shape[1], cfg)
        prep = rs.prep_scan(mvp.cuda(), vgrid, width, height, cfg)
        self.bflag = None
        if gates is not None:
            bounds, pmid = rs.apply_patch_gates(
                prep.bounds, prep.mid, prep.canch, gates[1],
                min(cfg.cw + 128, g.cl), g.cl)
            prep = prep._replace(bounds=bounds, mid=pmid)
            self.bflag = gates[0][0].contiguous()
        if mid is not None:
            prep = prep._replace(mid=mid(prep.mid))
        self.prep = prep
        self.texq = rs.pack_texture(texture)
        self.sargs = (prep.win[0], prep.w0[0], prep.bounds[0], g, cfg,
                      self.bflag)
        self.rec = self.solve()
        self.margs = self.sargs[:3] + (prep.canch[0], prep.mid[0],
                                       rs.minv_rows(mvp)[0], g, cfg,
                                       self.bflag)

    def solve(self):
        from .ops import raster_scan as rs

        return rs.solve_records(*self.sargs)

    def solve_twin(self):
        from .ops import raster_scan as rs

        return rs.solve_records_plain(*self.sargs)

    def march(self, **kw):
        from .ops import raster_scan as rs

        return rs.march_exact(self.rec, *self.margs, **kw)

    def twin(self, **kw):
        from .ops import raster_scan as rs

        return rs.march_exact_plain(self.rec, *self.margs, **kw)

    def bound(self, with_z, kernel="march"):
        return bound(*scan_bounds(self.prep, 0, self.g, self.cfg, self.texq,
                                  self.bflag, with_z)[kernel])


def build_cases(names):
    """-> [(name, Pass, march kwargs)] for the requested case names, each
    scene built once."""
    from .ops import raster_scan as rs

    out = []
    want = set(names)
    if want & {c for c in CASES if c.startswith(("d10", "quality",
                                                  "patch"))}:
        mesh, proj, vgrid, tex = scene(10, 1920, 1080)
        n = vgrid.shape[0]
        cfg = rs.suggest_scan_config(n, 1920, 1080)
        mvp0 = frame_mvp(mesh, proj, 0)
        variants = {
            "d10": (cfg, None, {}),
            "d10_colfix_none": (dataclasses.replace(cfg, colfix=None), None,
                                {}),
            "d10_hyps2": (dataclasses.replace(cfg, hyps=2), None, {}),
            "d10_wide": (cfg, lambda m: torch.where(m >= 0, -1, m), {}),
            "d10_skip": (cfg, lambda m: torch.full_like(m, -2), {}),
            "d10_cull": (dataclasses.replace(cfg, edge_cull_threshold=0.25),
                         None, {}),
            "d10_wire": (cfg, None, {"wire": True}),
        }
        for name, (c, mid, kw) in variants.items():
            if name in want:
                out.append((name, Pass(c, mvp0, vgrid, tex, 1920, 1080,
                                       mid=mid), kw))
        mvp = frame_mvp(mesh, proj, 74)
        vgrid_t = vgrid.transpose(0, 1).contiguous()
        tex_t = tex.transpose(0, 1).contiguous()
        for tier, kw in (("quality", {"quality": True}),
                         ("patch", {"patch": True, "colfix": 3})):
            if not want & {tier + "1", tier + "2"}:
                continue
            cfg1, cfg2 = rs.tier_configs(rs.suggest_scan_config(
                n, 1920, 1080, **kw), n, n, 1920, 1080)
            p1 = Pass(cfg1, mvp, vgrid, tex, 1920, 1080)
            out.append((tier + "1", p1, {"raster_z": True}))
            gates = None
            if tier == "patch":
                att = p1.march(raster_z=True)
                z = rs.shade(att, p1.texq, p1.g, cfg1, "texture_z")[1]
                g2 = rs.ScanGeometry.of(1080, 1920, n, n, cfg2)
                gates = rs.patch_flags(z[None], 1920, 1080, g2.nbands,
                                       g2.nblk)
            out.append((tier + "2", Pass(cfg2, rs.swap_mvps(mvp), vgrid_t,
                                         tex_t, 1080, 1920, gates),
                        {"raster_z": True}))
        out = [o for o in out if o[0] in want]
    for name, density, (w, h), frame in (("d11", 11, (1920, 1080), 74),
                                         ("p4", 12, (3840, 2160), 0)):
        if not want & {name, name + "_colfix_none"}:
            continue
        mesh, proj, vgrid, tex = scene(density, w, h)
        cfg = rs.suggest_scan_config(vgrid.shape[0], w, h,
                                     edge_cull_threshold=0.25)
        mvp = frame_mvp(mesh, proj, frame)
        if name in want:
            out.append((name, Pass(cfg, mvp, vgrid, tex, w, h), {}))
        if name + "_colfix_none" in want:
            out.append((name + "_colfix_none",
                        Pass(dataclasses.replace(cfg, colfix=None), mvp,
                             vgrid, tex, w, h), {}))
        del mesh
    return out


def pair_case(name):
    """-> (planes, config) of a :data:`PAIR_CASES` case: the first
    :data:`PAIR_FRAMES` frames of the tiled CLI run's 32 views at
    1080p/d10, at the config ``render_clip`` measures from them, through the
    Pallas route's prep (``tiled``) or the grid route's (``grid``)."""
    from . import animation, transforms
    from .ops import raster_grid as trg
    from .ops import raster_pallas as trp
    from .render import clip_mvps, tiled_config

    mesh, proj, vgrid, _ = scene(10, 1920, 1080)
    uv = mesh.texture_coordinates.reshape(vgrid.shape[:2] + (2,)).cuda()
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(32, 60.0)))
    mvps = clip_mvps(proj, views, mesh.transform).cuda()
    cfg = tiled_config(mvps, vgrid, uv, 1920, 1080)
    prep = trp._prep_stage_batched if name == "tiled" else trg._grid_group
    return prep(mvps[:PAIR_FRAMES], vgrid, uv, 1920, 1080, cfg), cfg


def _frame_tiles(planes):
    """(frames, kernel tiles a frame, windows a tile) of a group's planes."""
    cov, origin, px0 = planes[0], planes[2], planes[4]
    n = px0.shape[0]
    return cov.shape[0], n // max(cov.shape[0], 1), origin.shape[0] // max(
        n, 1)


def pair_bounds(planes, config):
    """(bytes, operations, active pairs) of one pair kernel launch on a frame
    group's tables: each table column that an active chunk holds read once
    (its 12 cov floats), the window and tile integers read and the rows
    written once, :data:`PAIR_OPS` per active pair. The winners' attr
    columns (at most one a pixel, ~0.1 GB a 1080p frame) are left out: the
    bound is operations by far."""
    from .ops import tiled

    cov, _, origin, rel, px0, py0, jlo, jhi = planes
    frames, m, wpt = _frame_tiles(planes)
    nch, tc = rel.shape
    ncol = cov.shape[2]
    j = torch.arange(wpt * nch, device=cov.device)
    touched = 0
    for f in range(frames):
        t = slice(f * m, (f + 1) * m)
        act = (j >= jlo[t, None]) & (j < jhi[t, None])
        ti, jj = torch.nonzero(act, as_tuple=True)
        r = rel.long()[jj % nch]                                 # (k, TC)
        w = (f * m + ti) * wpt + torch.div(jj, nch, rounding_mode="floor")
        cols = (origin[w, None] - f * 12 * ncol + r)[r >= 0]
        mask = torch.zeros(ncol, dtype=torch.bool, device=cov.device)
        mask[cols] = True
        touched += int(mask.sum())
    P = config.tile_h * config.tile_w
    pairs = tiled.active_pairs(jlo, jhi, tc, P)
    moved = (touched * 12 * 4
             + _nbytes(origin, rel, px0, py0, jlo, jhi)
             + px0.shape[0] * P * 8 * 4)
    return moved, PAIR_OPS * pairs, pairs


def twin_rows(planes, height, config, sel=None):
    """The plain twin's rows of a frame group's tiles (or of the kernel
    tiles ``sel`` within each frame, every frame), frame by frame: each
    frame's windows gathered out of its table, one frame's at a time."""
    from .ops import tiled

    cov, attr, origin, rel, px0, py0, jlo, jhi = planes
    frames, m, wpt = _frame_tiles(planes)
    ncol = cov.shape[2]
    out = []
    for f in range(frames):
        t = (torch.arange(f * m, (f + 1) * m, device=cov.device)
             if sel is None else f * m + sel)
        w = (t[:, None] * wpt + torch.arange(wpt, device=cov.device)
             ).reshape(-1)
        win = tiled.gather_windows((cov[f], attr[f],
                                    origin[w] - f * 12 * ncol, rel.long()))
        win = [x.reshape((t.numel(), -1) + x.shape[2:]) for x in win]
        out.append(tiled.raster_pairs_plain(*win, px0[t], py0[t], jlo[t],
                                            jhi[t], height, config))
        del win
    return torch.cat(out)


class _GatheredPairParams(ctypes.Structure):
    """``struct PairParams`` of a pair.cu of the gathered-window interface
    (field order and types must match)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "ntiles", "nchunks", "tc", "tile_h", "tile_w", "height")]


def gathered_pairs(lib, windows, planes, height, config):
    """One launch of a pair.cu of the gathered-window interface:
    ``pair_raster(cov, attr, px0, py0, jlo, jhi, out, params, stream)`` on
    (ntiles, chunks, 12, TC) window copies -> (ntiles, P, 8) rows."""
    cov_w, attr_w = windows
    n, nch, _, tc = cov_w.shape
    P = config.tile_h * config.tile_w
    out = torch.empty((n, P, 8), dtype=torch.float32, device=cov_w.device)
    params = _GatheredPairParams(n, nch, tc, config.tile_h, config.tile_w,
                                 height)
    ptrs = [cov_w, attr_w, *planes[4:], out]
    err = lib.pair_raster(*[ctypes.c_void_p(t.data_ptr()) for t in ptrs],
                          ctypes.byref(params), ctypes.c_void_p(
                              torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"pair_raster (beside) launch failed: {err}")
    return out


def grid_sample_call(att, texq):
    """``F.grid_sample`` computing the shade's bilinear clamp-to-edge
    sample of the texture at the attrs' (u, v) -> a no-argument call."""
    import torch.nn.functional as F

    tex = torch.stack([(texq >> s) & 0xFF for s in (0, 8, 16, 24)]
                      ).float()[None]                     # (1, 4, Ht, Wt)
    grid = torch.stack([2.0 * att[0] - 1.0, 1.0 - 2.0 * att[1]], dim=-1
                       )[None].contiguous()              # (1, HPAD, WL, 2)
    return lambda: F.grid_sample(tex, grid, mode="bilinear",
                                 padding_mode="border", align_corners=False)


def build_libs(beside=None, source="scan.cu"):
    """Build ``csrc/<source>`` (and ``beside``, into ``build/beside/``), one
    nvcc each, started together -> {label: (source, library, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    from .ops import cuda_build

    lib = cuda_build.library_path(source)
    jobs = {"this": (cuda_build.CSRC / source, lib)}
    if beside is not None:
        jobs["beside"] = (beside, cuda_build.BUILD_DIR / "beside" / lib.name)

    def one(job):
        t0 = time.perf_counter()
        cuda_build.build(source, force=True, src=job[0], lib=job[1])
        return job + (time.perf_counter() - t0,)

    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(one, job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--beside", type=Path, default=None,
                    help="also time this other scan.cu on the same inputs, "
                         "in turns with the first")
    ap.add_argument("--beside-pair", type=Path, default=None,
                    dest="beside_pair",
                    help="also time this pair.cu of the gathered-window "
                         "interface on the same frames, in turns")
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS)
    ap.add_argument("--cases", nargs="+", default=list(CASES + PAIR_CASES),
                    choices=CASES + PAIR_CASES)
    ap.add_argument("--check", action="store_true",
                    help="hold each case but preset 4's march, every solve "
                         "and shade case and every pair case against the "
                         "plain twin")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("march_times needs a CUDA device")
    from .ops import cuda_build
    from .ops import raster_scan as rs
    from .ops import tiled
    from .probes.__main__ import graph_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "builds": {}, "cases": {}}
    libs, pair_libs = {}, {}
    scan_kernels = [k for k in args.kernels if k != "pairs"]
    builds = {}
    if scan_kernels:
        builds["scan"] = build_libs(args.beside)
    if "pairs" in args.kernels:
        builds["pair"] = build_libs(args.beside_pair, "pair.cu")
    for source, built in builds.items():
        for label, (src, lib, build_s) in built.items():
            print(f"[march_build] lib={label} src={src} card={card!r} "
                  f"build_s={build_s:.2f}", flush=True)
            if source == "scan":
                libs[label] = rs._load_lib(lib)
                usage = {k: rs.kernel_ptxas(k, lib) for k in scan_kernels}
            else:
                pair_libs[label] = ctypes.CDLL(str(lib))
                usage = {"pair": cuda_build.ptxas_usage(lib)}
            result["builds"][f"{source}_{label}"] = {"src": str(src),
                                                    "ptxas": usage}
            for kernel, instances in usage.items():
                for name, u in instances.items():
                    print(f"[{kernel}_ptxas] lib={label} "
                          f"{name.replace(' ', '')} "
                          + " ".join(f"{k}={v}" for k, v in u.items()),
                          flush=True)
    if libs:
        rs._lib = libs["this"]
    if pair_libs:
        tiled._lib = tiled.bind(pair_libs["this"])

    def timed(fn, clock=lambda f: cuda_ms(f, args.reps)):
        """{label: ms}: ``this`` alone, or beside, this, this, beside."""
        order = (["beside", "this", "this", "beside"] if "beside" in libs
                 else ["this"])
        runs = {k: [] for k in libs}
        for label in order:
            rs._lib = libs[label]
            runs[label].append(clock(fn))
        rs._lib = libs["this"]
        return {k: sum(v) / len(v) for k, v in runs.items()}

    def report(kernel, name, row, t, b_ms, b_by):
        row.update(ms=t["this"], bound_ms=b_ms, bound_by=b_by)
        if "beside" in t:
            row["beside_ms"] = t["beside"]
        result["cases"].setdefault(name, {})[kernel] = row
        print(f"[{kernel}] case={name} ms={t['this']:.4f} "
              + (f"beside_ms={t['beside']:.4f} " if "beside" in t else "")
              + f"bound_ms={b_ms:.4f} bound_by={b_by} "
              + " ".join(f"{k}={v}" for k, v in row.items()
                         if k not in ("ms", "bound_ms", "bound_by",
                                      "beside_ms")), flush=True)

    scan_cases = [c for c in args.cases if c in CASES] if scan_kernels else []
    for name, ps, kw in build_cases(scan_cases):
        with_z = kw.get("raster_z", False)
        if "march" in args.kernels:
            row = {"cfg": (
                f"sr{ps.cfg.sr}/hyps{ps.cfg.hyps}/colfix{ps.cfg.colfix}/"
                f"cw{ps.cfg.cw}/big{int(ps.cfg.big_grid)}/"
                f"cull{ps.cfg.edge_cull_threshold}")}
            t = timed(lambda: ps.march(**kw))
            if args.check and not name.startswith("p4"):
                band_rows = (slice(None) if ps.bflag is None
                             else ps.bflag.bool().repeat_interleave(8))
                att = ps.march(**kw)
                row["max_abs_vs_twin"] = float(
                    (att[:, band_rows] - ps.twin(**kw)[:, band_rows])
                    .abs().max())
            report("march", name, row, t, *ps.bound(with_z, "march"))
        if "solve" in args.kernels and name in SOLVE_CASES:
            row = {"cfg": f"sr{ps.cfg.sr}/nbr{ps.cfg.nbr}/"
                          f"dual{int(ps.cfg.dual_col)}/"
                          f"big{int(ps.cfg.big_grid)}/rmax{ps.cfg.rmax}"}
            t = timed(ps.solve)
            if args.check:
                on = (slice(None) if ps.bflag is None
                      else ps.bflag.bool())   # records defined there
                row["equal_twin"] = torch.equal(
                    ps.solve()[on].view(torch.int32),
                    ps.solve_twin()[on].view(torch.int32))
            report("solve", name, row, t, *ps.bound(with_z, "solve"))
        if "shade" in args.kernels and name in SOLVE_CASES:
            mode = "texture_z" if with_z else "texture"
            att = ps.march(**kw)
            row = {"mode": mode, "timing": "graph_slope_20_40"}

            def shade():
                return rs.shade(att, ps.texq, ps.g, ps.cfg, mode, ps.bflag)

            t = timed(shade, lambda f: graph_ms(f, 20))
            row["library_ms"] = graph_ms(grid_sample_call(att, ps.texq), 20)
            row["stream_ms"] = cuda_ms(shade, 50)
            if args.check:
                got = shade()
                want = rs.shade_plain(att, ps.texq, *ps.texq.shape, mode,
                                      ps.bflag)
                row["equal_twin"] = all(
                    torch.equal(a, b) for a, b in
                    zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))))
            report("shade", name, row, t, *ps.bound(with_z, "shade"))
        del ps
        torch.cuda.empty_cache()

    pair_cases = ([c for c in args.cases if c in PAIR_CASES]
                  if "pairs" in args.kernels else [])
    for name in pair_cases:
        planes, cfg = pair_case(name)
        height = 1080
        frames = planes[0].shape[0]
        beside = pair_libs.get("beside")
        tables_too = beside is not None and hasattr(beside, "pair_threads")
        windows = (tiled.gather_tables(*planes[:4], planes[4].shape[0])
                   if beside is not None and not tables_too else None)

        def run(label):
            if label == "this" or tables_too:
                tiled._lib = tiled.bind(pair_libs[label])
                return tiled.raster_pairs(*planes, height, cfg)
            return gathered_pairs(beside, windows, planes, height, cfg)

        runs = {"this": [], "beside": []}
        for label in (["beside", "this", "this", "beside"] if beside
                      else ["this"]):
            runs[label].append(cuda_ms(lambda: run(label), 3))
        t = {k: sum(v) / len(v) for k, v in runs.items() if v}
        tc, nch = planes[3].shape[1], planes[3].shape[0]
        row = {"frames": frames,
               "ms_per_frame": t["this"] / frames,
               "window": f"{cfg.window_rows}x{cfg.window_cols}",
               "tc": tc, "chunks": nch, "windows_a_tile":
                   planes[2].shape[0] // planes[4].shape[0],
               "table_gb_per_frame": _nbytes(*planes[:2]) / frames / 1e9}
        if beside is not None:
            row["beside_ms_per_frame"] = t["beside"] / frames
            row["beside_iface"] = "tables" if tables_too else "gathered"
            row["beside_rows_equal"] = torch.equal(run("beside"),
                                                   run("this"))
        del windows
        moved, ops, pairs = pair_bounds(planes, cfg)
        row["active_pairs_per_frame"] = pairs // frames
        if args.check:
            row["equal_twin"] = torch.equal(
                tiled.raster_pairs(*planes, height, cfg),
                twin_rows(planes, height, cfg))
        report("pairs", name, row, t, *bound(moved, ops))
        del planes
        torch.cuda.empty_cache()

    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    bad = {f"{c}/{k}": v for c, ks in result["cases"].items()
           for k, v in ks.items()
           if v.get("max_abs_vs_twin", 0.0) != 0.0
           or not v.get("equal_twin", True)
           or not v.get("beside_rows_equal", True)}
    if bad:
        raise SystemExit(f"kernels differ from their twins: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
