"""Compare trees of the port on one card, run after run in a given order.

    python3 ab_times.py --trees DIR [DIR ...] [--order 0,1,1,0]
                        [--measure render cli farm]

Each entry of ``--order`` (an index into ``--trees``, default ``0,1,1,0``)
runs ``ab_times.py --once`` in its own process with that tree as the
working directory, so each run imports that tree's package and builds its
kernels into that tree's ``depthrenderer_tpu_torch/build/`` (the first run
of a tree pays the build in its warm-up). A run measures, on the seeded
synthetic scene, what ``--measure`` names (default ``render cli``):

- ``render``, ``render_only_fps``: ``render_clip`` at 1920x1080, mesh
  density 10, one sway loop (300 frames) after a 16-frame warm-up, frames
  to the host and not encoded (the tree's ``chip_smoke.render_fps``);
- ``cli``, ``cli_fps``: ``cli.render_scene`` over the same 300 frames into
  an MJPG AVI, encode included, after a 16-frame warm-up;
- ``farm``, where the tree has ``depthrenderer_tpu_torch/batch.py``: the
  farm at its defaults (640x480, d8, 300 frames a model, the smoke's
  four models, ``chip_smoke.write_farm_inputs``), sequential, ``--sharded
  --readback yuv420`` and ``--sharded --readback rgba``, each ``--no-post``:
  aggregate frames/s incl. encode (``farm_*_fps``).

Each run prints one line ``AB {json}``, after a first line with the card's
name and power limit. Times are host clock over whole runs: compare trees
only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def once(measure):
    sys.path[0] = os.getcwd()
    import torch

    import chip_smoke as cs
    from depthrenderer_tpu_torch import cli
    from depthrenderer_tpu_torch.synthetic import synthetic_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    colour, depth = synthetic_scene()
    out = {"tree": os.path.basename(os.getcwd())}
    if "render" in measure:
        mesh, projection = cs.smoke_scene(colour, depth,
                                          torch.device("cuda"))[:2]
        out["render_only_fps"] = cs.render_fps(mesh, projection, 300, 16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def run(frames):
            args = cli.build_parser().parse_args(
                ["scene.png", "scene_depth.png", "-mesh-density", "10",
                 "--width", "1920", "--height", "1080", "--frames",
                 str(frames), "-output-path", str(tmp / "cli")])
            return cli.render_scene(colour, depth, args)

        if "cli" in measure:
            run(16)
            out["cli_fps"] = 300 / run(300)["seconds"]
        if "farm" in measure and Path(
                "depthrenderer_tpu_torch/batch.py").exists():
            from depthrenderer_tpu_torch import batch

            image, models, _ = cs.write_farm_inputs(colour, depth,
                                                    tmp / "farm_in")
            runs = {"seq": [], "yuv420": ["--sharded", "--readback",
                                          "yuv420"],
                    "rgba": ["--sharded", "--readback", "rgba"]}
            for name, extra in runs.items():
                args = batch.build_parser().parse_args(
                    [str(image), str(models), "-output-path",
                     str(tmp / name), "--no-post", *extra])
                res = batch.run_farm(args)
                out[f"farm_{name}_fps"] = res["frames"] / res["seconds"]
    print("AB " + json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--measure", nargs="+", default=["render", "cli"],
                    choices=["render", "cli", "farm"])
    ap.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.once:
        once(args.measure)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    script = str(Path(__file__).resolve())
    for i in (int(k) for k in args.order.split(",")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, script, "--once", "--measure",
                        *args.measure], cwd=args.trees[i], check=True)
        print(f"run of {args.trees[i]}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
