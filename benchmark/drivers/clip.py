"""Traffic ``clip``: what a CLI user waits for.

Per clip, as one request: ``cli.render_scene(colour, depth, args)`` with
``args`` from ``cli.build_parser()`` at the configuration's size, density
and frame count, writing the MJPG AVI and the sample PNG into the run's
temporary directory. Every clip's files stay until the window has closed;
then every AVI's frames are counted, a seeded sample of clips is checked
and everything is deleted.

The numbers compared:

* ``png_off1_share``: the sample PNG (lossless) against the float64
  reference, as ``frames``' ``off1_share``;
* ``avi_frames_short``: frames missing from (or extra in) the AVIs,
  summed over the counted clips (an AVI of another size, or none, counts
  every frame); exact;
* ``avi_wrong_frame``: checked AVI frames (decoded by Pillow) that lie
  nearer, on the checked rows, to the reference's frame ``SHIFT`` earlier
  or later than to their own; exact. The sway moves the camera tens of
  pixels in ``SHIFT`` frames, far beyond the JPEG's loss.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np

from benchmark import avi, check, scenes

SHIFT = 8


class Driver:
    def __init__(self, run):
        self.run = run
        c = run.config
        self.width, self.height = c["width"], c["height"]
        self.frames = c["frames_per_clip"]
        chk = run.workload["check"]
        self.rows = chk["rows"]
        self.reservoir = check.Reservoir(chk["clips"], run.seed)
        self.outputs = {}   # clip -> (scene index, video path, sample path)
        self.scenes = []
        self.tmp = None

    def _args(self, out: Path, frames: int):
        c = self.run.config
        argv = ["scene.png", "scene_depth.png",
                "--width", str(self.width), "--height", str(self.height),
                "-mesh-density", str(c["mesh_density"]),
                "-displacement-factor", str(c["displacement_factor"]),
                "-fps", str(c["fps"]), "--fov-y", str(c["fov_y"]),
                "--frames", str(frames), "-output-path", str(out),
                "--device", self.run.device]
        if c.get("edge_cull_threshold") is not None:
            argv += ["--edge-cull", str(c["edge_cull_threshold"])]
        return self.parser.parse_args(argv)

    def setup(self):
        from depthrenderer_tpu_torch import cli, native

        self.cli = cli
        self.parser = cli.build_parser()
        run = self.run
        traffic = run.workload["traffic"]
        self.tmp = Path(tempfile.mkdtemp(prefix="bench_clip_"))
        with run.timed("build_s"):
            native.build()
            if run.device == "cuda":
                from depthrenderer_tpu_torch.ops import cuda_build

                cuda_build.build("scan.cu")
        with run.timed("scenes_s"):
            self.scenes = scenes.scene_pool(run.seed, traffic["scene_pool"],
                                            self.height, self.width,
                                            run.device)
        with run.timed("warm_s"):
            colour, depth = self.scenes[0]
            warm = self.tmp / "warm"
            self.cli.render_scene(colour, depth,
                                  self._args(warm, traffic["warm_frames"]))
            shutil.rmtree(warm)

    def clip(self, k: int) -> int:
        run = self.run
        scene_index = k % len(self.scenes)
        colour, depth = self.scenes[scene_index]
        out = self.tmp / f"clip{k:05d}"
        with run.span("bench.render_scene"):
            result = self.cli.render_scene(colour, depth,
                                           self._args(out, self.frames))
        self.outputs[k] = (scene_index, result["video"], result["sample"])
        slot = self.reservoir.offer(k)
        if slot is not None:
            rng = check.clip_rng(run.seed, k)
            pick = int(rng.integers(SHIFT, self.frames - SHIFT))
            rows = check.pick_rows(rng, self.height, self.rows)
            self.reservoir.put(slot, (k, pick, rows))
        return int(result["frames"])

    def release(self):
        self.cli = None

    def _avi_short(self, path) -> int:
        try:
            w, h, _ = avi.header(path)
            n = len(avi.frame_payloads(path))
        except (OSError, ValueError):
            return self.frames
        if (w, h) != (self.width, self.height):
            return self.frames
        return abs(self.frames - n)

    def check(self, control: bool = False):
        """-> ({png_off1_share, avi_frames_short, avi_wrong_frame}, failed
        clips)."""
        run = self.run
        limit = run.workload["check"]["limits"]["png_off1_share"]
        sample = run.config["sample_frame"]
        ref = check.Reference(run.config, self.scenes, run.device)
        failed, short = set(), 0
        run.notes["written_mb"] = sum(
            f.stat().st_size for f in self.tmp.rglob("*") if f.is_file()) / 2**20
        for k, (_, video, _) in self.outputs.items():
            s = self._avi_short(video)
            short += s
            if s:
                failed.add(k)
        shares, wrong = [], 0
        for k, pick, rows in sorted(self.reservoir.items(),
                                    key=lambda it: self.outputs[it[0]][0]):
            scene_index, video, png = self.outputs[k]
            want = ref.rows(scene_index, sample, rows)
            if control:
                got = check.control_rows(ref, scene_index, sample, rows)
            else:
                try:
                    got = avi.read_png(png)[rows]
                except OSError:
                    got = np.zeros_like(want)
            share = check.off1_share(got, want)
            shares.append(share)
            try:
                frame = avi.decode_jpeg(avi.frame_payloads(video)[pick])
                seen = frame[rows].astype(np.float64)
            except (OSError, ValueError, IndexError):
                seen = None
            if seen is not None and seen.shape[1] == self.width:
                err = [np.mean((seen - ref.rows(scene_index, f, rows)[..., :3])
                               ** 2) for f in (pick - SHIFT, pick,
                                               pick + SHIFT)]
                bad = int(np.argmin(err)) != 1
            else:
                bad = True
            wrong += bad
            if share > limit or bad:
                failed.add(k)
        return ({"png_off1_share": max(shares), "avi_frames_short": short,
                 "avi_wrong_frame": wrong}, failed)

    def close(self):
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
        self.scenes = []
