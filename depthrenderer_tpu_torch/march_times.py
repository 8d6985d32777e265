"""The scan's march and solve kernels on one card: times case by case beside
the bound, and ptxas's registers and spills per kernel instance.

    python -m depthrenderer_tpu_torch.march_times [--beside PATH]
        [--kernels march solve] [--cases NAME ...] [--check] [--reps N]
        [--json PATH]

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

The solve is timed on the cases whose records differ (:data:`SOLVE_CASES`:
``d10``, the tiers' four passes, ``d11``, ``p4``). ``--beside`` builds
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
pixel per swept record column). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM: HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM: float32 outside the tensor cores
CASES = ("d10", "d10_colfix_none", "d10_hyps2", "d10_wide", "d10_skip",
         "d10_cull", "d10_wire", "quality1", "quality2", "patch1", "patch2",
         "d11", "d11_colfix_none", "p4", "p4_colfix_none")
SOLVE_CASES = ("d10", "quality1", "quality2", "patch1", "patch2", "d11",
               "p4")
KERNELS = ("march", "solve")


def bound(nbytes, ops):
    """(bound_ms, bound_by): the card's least time for this work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def scan_bounds(prep, i, g, cfg, texq, bflag=None, with_z=False):
    """Bytes and operations of the three scan kernels on frame i; with a
    band flag (sparse bands) the records, the window and the attributes
    read count only the flagged bands' share. The attributes are 4 planes;
    ``with_z`` (the tiers' passes): the march also writes the raster-z
    plane, and the shade reads it and writes the raster z. A big_grid
    block sweeps its whole 128-aligned fetch window (``min(cw + 128,
    CL)`` columns)."""
    from .ops import raster_scan as rs

    share = 1.0 if bflag is None else float(bflag.float().mean())
    rec = g.nbands * cfg.nbr * cfg.nrec * 8 * g.cl * 4 * share
    attrs = rs.n_attrs(with_z) * g.hpad * g.wl * 4
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
    march = (rec + win + _nbytes(prep.canch[i], prep.mid[i]) + ints + attrs,
             2 * 1024 * int(cols.sum()))
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


def build_libs(beside=None):
    """Build ``csrc/scan.cu`` (and ``beside``, into ``build/beside/``), one
    nvcc each, started together -> {label: (source, library, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    from .ops import cuda_build

    jobs = {"this": (cuda_build.CSRC / "scan.cu",
                     cuda_build.library_path("scan.cu"))}
    if beside is not None:
        jobs["beside"] = (beside,
                          cuda_build.BUILD_DIR / "beside" / "libscan.so")

    def one(job):
        t0 = time.perf_counter()
        cuda_build.build("scan.cu", force=True, src=job[0], lib=job[1])
        return job + (time.perf_counter() - t0,)

    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(one, job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--beside", type=Path, default=None,
                    help="also time this other scan.cu on the same inputs, "
                         "in turns with the first")
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS)
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--check", action="store_true",
                    help="hold each case but preset 4's march, and every "
                         "solve case, against the plain twin")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("march_times needs a CUDA device")
    from .ops import cuda_build
    from .ops import raster_scan as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    builds = build_libs(args.beside)
    libs, result = {}, {"card": card, "builds": {}, "cases": {}}
    for label, (src, lib, build_s) in builds.items():
        libs[label] = rs._load_lib(lib)
        print(f"[march_build] lib={label} src={src} card={card!r} "
              f"build_s={build_s:.2f}", flush=True)
        usage = {k: rs.kernel_ptxas(k, lib) for k in ("march", "solve")}
        result["builds"][label] = {"src": str(src), "ptxas": usage}
        for kernel, instances in usage.items():
            for name, u in instances.items():
                print(f"[{kernel}_ptxas] lib={label} {name.replace(' ', '')} "
                      + " ".join(f"{k}={v}" for k, v in u.items()),
                      flush=True)
    rs._lib = libs["this"]

    def timed(fn):
        """{label: ms}: ``this`` alone, or beside, this, this, beside."""
        order = (["beside", "this", "this", "beside"] if "beside" in libs
                 else ["this"])
        runs = {k: [] for k in libs}
        for label in order:
            rs._lib = libs[label]
            runs[label].append(cuda_ms(fn, args.reps))
        rs._lib = libs["this"]
        return {k: sum(v) / len(v) for k, v in runs.items()}

    for name, ps, kw in build_cases(args.cases):
        with_z = kw.get("raster_z", False)
        rows = {}
        if "march" in args.kernels:
            rows["march"] = row = {"cfg": (
                f"sr{ps.cfg.sr}/hyps{ps.cfg.hyps}/colfix{ps.cfg.colfix}/"
                f"cw{ps.cfg.cw}/big{int(ps.cfg.big_grid)}/"
                f"cull{ps.cfg.edge_cull_threshold}")}
            ms = timed(lambda: ps.march(**kw))
            if args.check and not name.startswith("p4"):
                band_rows = (slice(None) if ps.bflag is None
                             else ps.bflag.bool().repeat_interleave(8))
                att = ps.march(**kw)
                row["max_abs_vs_twin"] = float(
                    (att[:, band_rows] - ps.twin(**kw)[:, band_rows])
                    .abs().max())
        if "solve" in args.kernels and name in SOLVE_CASES:
            rows["solve"] = row = {
                "cfg": f"sr{ps.cfg.sr}/nbr{ps.cfg.nbr}/"
                       f"dual{int(ps.cfg.dual_col)}/"
                       f"big{int(ps.cfg.big_grid)}/rmax{ps.cfg.rmax}"}
            ms_s = timed(ps.solve)
            if args.check:
                on = (slice(None) if ps.bflag is None
                      else ps.bflag.bool())   # records defined there
                row["equal_twin"] = torch.equal(
                    ps.solve()[on].view(torch.int32),
                    ps.solve_twin()[on].view(torch.int32))
        for kernel, row in rows.items():
            t = ms if kernel == "march" else ms_s
            b_ms, b_by = ps.bound(with_z, kernel)
            row.update(ms=t["this"], bound_ms=b_ms, bound_by=b_by)
            if "beside" in t:
                row["beside_ms"] = t["beside"]
            result["cases"].setdefault(name, {})[kernel] = row
            print(f"[{kernel}] case={name} ms={t['this']:.4f} "
                  + (f"beside_ms={t['beside']:.4f} " if "beside" in t
                     else "")
                  + f"bound_ms={b_ms:.4f} bound_by={b_by} "
                  + " ".join(f"{k}={v}" for k, v in row.items()
                             if k not in ("ms", "bound_ms", "bound_by",
                                          "beside_ms")),
                  flush=True)
        del ps
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    bad = {f"{c}/{k}": v for c, ks in result["cases"].items()
           for k, v in ks.items()
           if v.get("max_abs_vs_twin", 0.0) != 0.0
           or not v.get("equal_twin", True)}
    if bad:
        raise SystemExit(f"kernels differ from their twins: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
