"""Traffic ``farm``: what a researcher comparing depth-estimation models
runs, ``render_many.py`` as the port ships it (``batch.run_farm``).

Per job, as one request: ``batch.run_farm(args)`` with ``args`` from
``batch.build_parser()``: one colour image of the pool against its folder of
depth maps, one a model (the configuration's ``depth_maps``), ``--sharded
--readback auto --no-post --codec MJPG`` at the configuration's size,
density and frame rate, writing each model's AVI, its PNG snapshots and the
manifest into the run's temporary directory. A job's frames are model-frames
(models x frames a model).

The pool is written as files in :meth:`Driver.setup`, outside the window:
each image is a seeded scene (:mod:`benchmark.scenes`) with its depth map
(the ground truth) and the ground truth overlaid with Perlin noise as
``overlay_noise`` does (the noise min-max normalised to 0-255 and added,
the sum rescaled by its maximum), each map saved as 8 bits spanning 0-255,
as a depth model's normalised output is (the farm's loader then leaves it
as it is). Every job's files stay until the window has closed (a run
writes ~2 GB); then every AVI's frames are counted, the sample is checked
and everything is deleted, so no count or deletion falls inside the window.

The numbers compared:

* ``png_off1_share``: a seeded PNG snapshot of each model of each checked
  job (lossless) against the float64 reference, as ``frames``'
  ``off1_share``; the largest;
* ``avi_frames_short``: frames missing from (or extra in) the models'
  AVIs, summed over the counted jobs (an AVI of another size, or none,
  counts every frame); exact;
* ``avi_wrong_frame``: checked AVI frames (one seeded frame a model, decoded
  by Pillow) that lie nearer, on the checked rows, to their model's
  reference frame ``SHIFT`` earlier or later than to their own; exact;
* ``avi_wrong_model``: the same frames that lie nearer to another model's
  reference frame than to their own model's; exact: a shard's frames in
  another model's file.
"""

from __future__ import annotations

import mmap
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark import avi, check, scenes

SHIFT = 8
IMAGE = "img{:02d}.png"
GRADIENTS = ((0, 1), (0, -1), (1, 0), (-1, 0))


def perlin(height: int, width: int, scale: int, seed: int, device="cpu"):
    """(height, width) float64 gradient noise with the fade ``6t^5 - 15t^4
    + 10t^3`` over ``scale`` lattice cells a side, its permutation drawn
    from ``seed`` (the reference's ``utils.py:541-591`` algorithm)."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    p = torch.randperm(256, generator=gen).to(device)
    p = torch.cat([p, p])
    f64 = torch.float64
    x = (torch.arange(width, dtype=f64, device=device) * (scale / width)
         )[None, :].expand(height, width)
    y = (torch.arange(height, dtype=f64, device=device) * (scale / height)
         )[:, None].expand(height, width)
    xi, yi = x.long(), y.long()
    xf, yf = x - xi, y - yi
    grads = torch.tensor(GRADIENTS, dtype=f64, device=device)

    def gradient(h, gx, gy):
        g = grads[h % 4]
        return g[..., 0] * gx + g[..., 1] * gy

    def fade(t):
        return 6 * t ** 5 - 15 * t ** 4 + 10 * t ** 3

    u, v = fade(xf), fade(yf)
    n00 = gradient(p[p[xi] + yi], xf, yf)
    n01 = gradient(p[p[xi] + yi + 1], xf, yf - 1)
    n11 = gradient(p[p[xi + 1] + yi + 1], xf - 1, yf - 1)
    n10 = gradient(p[p[xi + 1] + yi], xf - 1, yf)
    return torch.lerp(torch.lerp(n00, n10, u), torch.lerp(n01, n11, u), v)


def to_8bit(depth):
    """float64 depth -> uint8 spanning 0-255 (min-max, truncated)."""
    lo, hi = depth.min(), depth.max()
    return (255 * ((depth - lo) / (hi - lo))).to(torch.uint8)


def depth_maps(depth, maps, device="cpu"):
    """The configuration's ``depth_maps`` of one image's (H, W) uint8
    ground truth -> one (H, W) uint8 numpy map each, in order."""
    gt = torch.as_tensor(depth, device=device).to(torch.float64)
    out = []
    for m in maps:
        if "scale" not in m:
            out.append(to_8bit(gt))
            continue
        noise = perlin(*gt.shape, m["scale"], m["seed"], device)
        noise = 255 * (noise - noise.min()) / (noise.max() - noise.min())
        mixed = gt + noise
        out.append(to_8bit((255 * (mixed / mixed.max())).floor()))
    return [d.cpu().numpy() for d in out]


def frame_count(path) -> int:
    """The video frame chunks of an AVI's ``movi`` list, counted in place
    (the file mapped, no payload copied)."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as data:
        for cid, start, size in avi._chunks(data, 12, len(data)):
            if cid == b"LIST" and data[start:start + 4] == b"movi":
                return sum(1 for c, _, _ in avi._chunks(
                    data, start + 4, start + size)
                    if c[2:] in avi._FRAME_CHUNKS)
    raise ValueError(f"{path} has no movi list")


def write_png(array, path):
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(array)).save(path)


class Driver:
    def __init__(self, run):
        self.run = run
        c = run.config
        traffic = run.workload["traffic"]
        self.width, self.height = c["width"], c["height"]
        self.maps = c["depth_maps"]
        if traffic["models_per_job"] != len(self.maps):
            raise ValueError(f"models_per_job {traffic['models_per_job']} but "
                             f"{len(self.maps)} depth maps in the config")
        self.models = sorted(m["name"] for m in self.maps)   # the farm's order
        self.frames = traffic["frames_per_model"]
        self.every = traffic["png_every_frames"]
        chk = run.workload["check"]
        self.rows = chk["rows"]
        self.reservoir = check.Reservoir(chk["clips"], run.seed)
        self.outputs = {}   # job -> (image index, output directory)
        self.images = []    # (colour, {model: depth}) as written
        self.tmp = None

    def _args(self, image: int, out: Path):
        c = self.run.config
        pool = self.tmp / "pool"
        argv = [str(pool / IMAGE.format(image)),
                str(pool / f"depth{image:02d}"),
                "--width", str(self.width), "--height", str(self.height),
                "-mesh-density", str(c["mesh_density"]),
                "-displacement-factor", str(c["displacement_factor"]),
                "-fps", str(c["fps"]), "--fov-y", str(c["fov_y"]),
                "--frames", str(self.frames),
                "--png-every-seconds", repr(self.every / c["fps"]),
                "--codec", c["codec"], "--colfix", c["colfix"],
                "--readback", c["readback"], "--no-post",
                "-output-path", str(out), "--device", self.run.device]
        if c["sharded"]:
            argv.append("--sharded")
        if c.get("edge_cull_threshold") is not None:
            argv += ["--edge-cull", str(c["edge_cull_threshold"])]
        return self.parser.parse_args(argv)

    def setup(self):
        from depthrenderer_tpu_torch import batch, native

        self.batch = batch
        self.parser = batch.build_parser()
        run = self.run
        traffic = run.workload["traffic"]
        self.tmp = Path(tempfile.mkdtemp(prefix="bench_farm_"))
        with run.timed("build_s"):
            native.build()
            if run.device == "cuda":
                from depthrenderer_tpu_torch.ops import cuda_build

                cuda_build.build("scan.cu")
        with run.timed("scenes_s"):
            pool = self.tmp / "pool"
            pool.mkdir()
            for i, (colour, depth) in enumerate(scenes.scene_pool(
                    run.seed, traffic["scene_pool"], self.height, self.width,
                    run.device)):
                write_png(colour, pool / IMAGE.format(i))
                maps = dict(zip((m["name"] for m in self.maps),
                                depth_maps(depth, self.maps, run.device)))
                for name, d in maps.items():
                    folder = pool / f"depth{i:02d}" / name
                    folder.mkdir(parents=True)
                    write_png(d, folder / IMAGE.format(i))
                self.images.append((colour, maps))
        with run.timed("warm_s"):
            for j in range(traffic["warm_jobs"]):
                warm = self.tmp / f"warm{j}"
                self.batch.run_farm(self._args(j % len(self.images), warm))
                shutil.rmtree(warm)

    def clip(self, k: int) -> int:
        run = self.run
        image = k % len(self.images)
        out = self.tmp / f"job{k:05d}"
        with run.span("bench.farm"):
            result = self.batch.run_farm(self._args(image, out))
        self.outputs[k] = (image, out)
        slot = self.reservoir.offer(k)
        if slot is not None:
            rng = check.clip_rng(run.seed, k)
            pick = int(rng.integers(SHIFT, self.frames - SHIFT))
            due = np.arange(0, self.frames, self.every)
            shots = [int(rng.choice(due)) for _ in self.models]
            rows = check.pick_rows(rng, self.height, self.rows)
            self.reservoir.put(slot, (k, pick, shots, rows))
        return int(result["frames"])

    def video(self, k: int, model: str) -> Path:
        image, out = self.outputs[k]
        return (out / "single_videos" / Path(IMAGE.format(image)).stem
                / f"{model}.avi")

    def snapshot(self, k: int, model: str, frame: int) -> Path:
        return self.outputs[k][1] / "frames" / model / f"{frame:06d}.png"

    def _avi_short(self, path) -> int:
        try:
            w, h, _ = avi.header(path)
            n = frame_count(path)
        except (OSError, ValueError):
            return self.frames
        if (w, h) != (self.width, self.height):
            return self.frames
        return abs(self.frames - n)

    def release(self):
        self.batch = None

    def _decoded(self, k, model, pick, rows):
        try:
            payloads = avi.frame_payloads(self.video(k, model))
            frame = avi.decode_jpeg(payloads[pick])
        except (OSError, ValueError, IndexError):
            return None
        if frame.shape[1] != self.width:
            return None
        return frame[rows].astype(np.float64)

    def check(self, control: bool = False):
        """-> ({png_off1_share, avi_frames_short, avi_wrong_frame,
        avi_wrong_model}, failed jobs)."""
        run = self.run
        limit = run.workload["check"]["limits"]["png_off1_share"]
        M = len(self.models)
        # One reference scene an (image, model), at image * M + model.
        flat = [(colour, maps[m]) for colour, maps in self.images
                for m in self.models]
        ref = check.Reference(run.config, flat, run.device)
        run.notes["written_mb"] = sum(
            f.stat().st_size for _, out in self.outputs.values()
            for f in out.rglob("*") if f.is_file()) / 2**20
        short = {k: sum(self._avi_short(self.video(k, m))
                        for m in self.models) for k in self.outputs}
        failed = {k for k, s in short.items() if s}
        shares, wrong_frame, wrong_model = [], 0, 0

        def mse(seen, want):
            return float(np.mean((seen - want[..., :3]) ** 2))

        for k, pick, shots, rows in sorted(
                self.reservoir.items(), key=lambda it: self.outputs[it[0]][0]):
            image = self.outputs[k][0]
            seen, at_pick = [], []
            for m, model in enumerate(self.models):
                index = image * M + m
                want = ref.rows(index, shots[m], rows)
                if control:
                    got = check.control_rows(ref, index, shots[m], rows)
                else:
                    try:
                        got = avi.read_png(self.snapshot(k, model,
                                                         shots[m]))[rows]
                    except OSError:
                        got = np.zeros_like(want)
                share = check.off1_share(got, want)
                shares.append(share)
                if share > limit:
                    failed.add(k)
                near = [ref.rows(index, f, rows)
                        for f in (pick - SHIFT, pick, pick + SHIFT)]
                at_pick.append(near[1])
                frame = self._decoded(k, model, pick, rows)
                seen.append(frame)
                bad = (frame is None
                       or int(np.argmin([mse(frame, w) for w in near])) != 1)
                wrong_frame += bad
                if bad:
                    failed.add(k)
            for m, frame in enumerate(seen):
                bad = (frame is None or int(np.argmin(
                    [mse(frame, w) for w in at_pick])) != m)
                wrong_model += bad
                if bad:
                    failed.add(k)
        return ({"png_off1_share": max(shares),
                 "avi_frames_short": sum(short.values()),
                 "avi_wrong_frame": wrong_frame,
                 "avi_wrong_model": wrong_model}, failed)

    def close(self):
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
        self.images = []
