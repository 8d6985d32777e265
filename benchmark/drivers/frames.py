"""Traffic ``frames``: a library user who takes the frames (a novel-view
data pipeline), so the encoder is bypassed.

Per clip, as one request: ``Mesh.from_texture`` of the next scene of the
pool at the configuration's density, z times the displacement factor, the
camera's projection, the camera at ``dz`` behind the default sway over the
clip's frame times, then ``render.render_clip`` with a consumer that takes
every group of frames as host uint8 RGBA and keeps a copy of only the frame
the seed picks for the check.
"""

from __future__ import annotations

import numpy as np

from benchmark import check, scenes


class Driver:
    def __init__(self, run):
        self.run = run
        c = run.config
        self.width, self.height = c["width"], c["height"]
        self.frames = c["frames_per_clip"]
        chk = run.workload["check"]
        self.rows = chk["rows"]
        self.reservoir = check.Reservoir(chk["clips"], run.seed)
        self.short = {}   # clip -> frames it did not deliver
        self.scenes = []

    def setup(self):
        from depthrenderer_tpu_torch import animation, transforms
        from depthrenderer_tpu_torch.render import render_clip
        from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture

        self._api = (animation, transforms, render_clip, Camera, Mesh, Texture)
        run = self.run
        traffic = run.workload["traffic"]
        if run.device == "cuda":
            from depthrenderer_tpu_torch.ops import cuda_build

            with run.timed("build_s"):
                cuda_build.build("scan.cu")
        with run.timed("scenes_s"):
            self.scenes = scenes.scene_pool(run.seed, traffic["scene_pool"],
                                            self.height, self.width,
                                            run.device)
        # One clip of the cell's own shapes: groups of 16 frames and the
        # clip's last, shorter group.
        with run.timed("warm_s"):
            self._render(0, traffic["warm_frames"], lambda s, f: None)

    def _render(self, scene_index, frames, on_frames):
        animation, transforms, render_clip, Camera, Mesh, Texture = self._api
        run, c = self.run, self.run.config
        colour, depth = self.scenes[scene_index]
        with run.span("bench.meshgen"):
            mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                                     density=c["mesh_density"])
            mesh.vertices[:, 2] *= c["displacement_factor"]
        projection = Camera((colour.shape[1], colour.shape[0]),
                            fov_y=c["fov_y"]).projection
        views = transforms.matmul(
            transforms.translation(dz=c["camera_dz"])[None],
            animation.default_sway(c["sway_seconds"]).batch(
                animation.frame_times(frames, c["fps"])))
        with run.span("bench.render_clip"):
            render_clip(mesh, projection, views, self.width, self.height,
                        on_frames=on_frames, device=run.device,
                        edge_cull_threshold=c.get("edge_cull_threshold"))

    def clip(self, k: int) -> int:
        run = self.run
        slot = self.reservoir.offer(k)
        rng = check.clip_rng(run.seed, k)
        pick = int(rng.integers(self.frames))
        rows = check.pick_rows(rng, self.height, self.rows)
        kept, delivered = {}, [0]

        def consumer(start, frames):
            with run.span("bench.consumer"):
                delivered[0] += len(frames)
                if slot is not None and start <= pick < start + len(frames):
                    kept["frame"] = np.array(frames[pick - start])

        scene_index = k % len(self.scenes)
        self._render(scene_index, self.frames, consumer)
        if slot is not None:
            self.reservoir.put(slot, (k, scene_index, pick, rows,
                                      kept.get("frame")))
        self.short[k] = self.frames - delivered[0]
        return delivered[0]

    def release(self):
        self._api = None

    def check(self, control: bool = False):
        """-> ({off1_share, frames_short}, failed clips)."""
        run = self.run
        limit = run.workload["check"]["limits"]["off1_share"]
        ref = check.Reference(run.config, self.scenes, run.device)
        shares, failed = [], {k for k, s in self.short.items() if s}
        for k, scene_index, pick, rows, frame in sorted(
                self.reservoir.items(), key=lambda it: it[1]):
            want = ref.rows(scene_index, pick, rows)
            if control:
                got = check.control_rows(ref, scene_index, pick, rows)
            elif frame is None:
                got = np.zeros_like(want)
            else:
                got = frame[rows]
            share = check.off1_share(got, want)
            shares.append(share)
            if share > limit:
                failed.add(k)
        return ({"off1_share": max(shares),
                 "frames_short": sum(self.short.values())}, failed)

    def close(self):
        self.scenes = []
