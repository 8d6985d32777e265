"""``farm_roofline``: the least time one model-frame of the farm could take
on the card, over the device time per model-frame of all its CUDA kernels
(the union of their intervals in the traced job, copies and memsets left
out), in percent.

The bound depends only on the configuration's sizes. It is the larger of
two terms, as ``raster_roofline``'s, for what a model-frame delivers:

* bytes at the card's HBM rate: the grid's float32 x, y, z and the RGBA8
  texture read once, the YUV 4:2:0 planes written once (1.5 B a pixel),
  and the RGBA8 frame written only for the due PNG snapshots (one frame in
  ``fps * png_every_seconds``);
* operations at the card's float32 rate: ``raster_roofline``'s.
"""

import json
from pathlib import Path

from benchmark.harness import plugin

ROOF = plugin(Path(__file__).resolve().parent.parent, "metrics",
              "raster_roofline")
PLANE_BYTES = 1.5   # Y, and Cb and Cr at a quarter each, a pixel


def snapshot_every(config) -> int:
    """Model-frames a PNG snapshot."""
    return round(config["fps"] * config["png_every_seconds"])


def model_frame_bytes(config) -> float:
    n = 2 ** config["mesh_density"] + 1
    pixels = config["width"] * config["height"]
    return (n * n * ROOF.XYZ_BYTES_PER_VERTEX
            + config["texture_width"] * config["texture_height"]
            * ROOF.TEXEL_BYTES
            + pixels * (PLANE_BYTES
                        + ROOF.PIXEL_BYTES / snapshot_every(config)))


def model_frame_bound_s(config, peak) -> float:
    return max(model_frame_bytes(config) / peak["hbm_bytes_per_s"],
               ROOF.frame_flops(config) / peak["fp32_flops_per_s"])


def read(run):
    tr = run.trace
    with open(ROOF.PEAKS) as f:
        peak = json.load(f).get(run.device_kind)
    if tr is None or tr.frames == 0 or peak is None:
        return None
    from benchmark.devtrace import KERNEL, union_length

    kernel_s = union_length(tr.intervals((KERNEL,)))
    if kernel_s <= 0:
        return None
    return 100.0 * model_frame_bound_s(run.config, peak) / (kernel_s
                                                             / tr.frames)
