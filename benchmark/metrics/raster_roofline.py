"""``raster_roofline``: the least time one frame's rasterisation could take
on the card, over the device time per frame of all its CUDA kernels (the
union of their intervals in the traced clips, copies and memsets left
out), in percent.

The bound depends only on the configuration's sizes, never on how the port
divides the work (PyTorch prep ops and the scan's solve, march and shade
kernels), so it reads the same work whatever implements it. It is the
larger of two terms:

* bytes at the card's HBM rate: the grid's float32 x, y, z read once, the
  RGBA8 texture read once and the RGBA8 frame written once;
* operations at the card's float32 rate (no tensor cores): the 4x4 MVP
  product a vertex, and a pixel's barycentric weights and bilinear blend
  of 4 RGBA texels.
"""

import json
from pathlib import Path

XYZ_BYTES_PER_VERTEX = 12   # 3 float32
TEXEL_BYTES = 4             # RGBA8
PIXEL_BYTES = 4             # RGBA8
FLOPS_PER_VERTEX = 32       # 4x4 matrix times a 4-vector: 16 mul, 16 add
FLOPS_PER_PIXEL = 40        # barycentric weights, 4-texel RGBA blend
PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def frame_bytes(config) -> int:
    n = 2 ** config["mesh_density"] + 1
    return (n * n * XYZ_BYTES_PER_VERTEX
            + config["texture_width"] * config["texture_height"] * TEXEL_BYTES
            + config["width"] * config["height"] * PIXEL_BYTES)


def frame_flops(config) -> int:
    n = 2 ** config["mesh_density"] + 1
    return (n * n * FLOPS_PER_VERTEX
            + config["width"] * config["height"] * FLOPS_PER_PIXEL)


def frame_bound_s(config, peak) -> float:
    return max(frame_bytes(config) / peak["hbm_bytes_per_s"],
               frame_flops(config) / peak["fp32_flops_per_s"])


def read(run):
    tr = run.trace
    with open(PEAKS) as f:
        peak = json.load(f).get(run.device_kind)
    if tr is None or tr.frames == 0 or peak is None:
        return None
    from benchmark.devtrace import KERNEL, union_length

    kernel_s = union_length(tr.intervals((KERNEL,)))
    if kernel_s <= 0:
        return None
    return 100.0 * frame_bound_s(run.config, peak) / (kernel_s / tr.frames)
