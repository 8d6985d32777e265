"""Quality evaluation: PSNR between renders, away from depth
discontinuities.

Counterpart of ``depthrenderer_tpu/evaluate.py``. Depth-image rendering is
ambiguous at depth edges (rubber-sheet triangles), so a comparison may leave
out a neighbourhood of them. The videos decode on the host (:mod:`.video`);
the mask and the PSNR are computed in float64 on the chosen device (the
command line's ``--device``, ``cuda`` by default).

    python -m depthrenderer_tpu_torch.evaluate a.avi b.avi [--depth d.png]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from .utils import log


def discontinuity_mask(depth, threshold=16, dilate=3, device="cpu"):
    """(H, W) bool tensor: True within ``dilate`` pixels (Chebyshev) of a
    depth step larger than ``threshold``; ``depth`` (H, W) or (H, W, C),
    channel 0 read."""
    depth = torch.as_tensor(np.asarray(depth), device=device).to(torch.int32)
    if depth.ndim == 3:
        depth = depth[..., 0]
    edges = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    edges[:, 1:] |= (depth[:, 1:] - depth[:, :-1]).abs() > threshold
    edges[1:, :] |= (depth[1:, :] - depth[:-1, :]).abs() > threshold
    out = edges
    for _ in range(dilate):
        grown = out.clone()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def _psnr_of(mse, max_value):
    if mse == 0:
        return float("inf")
    return float(10.0 * math.log10(max_value**2 / mse))


def masked_psnr(a, b, depth=None, threshold=16, dilate=3, max_value=255.0,
                device="cpu"):
    """PSNR between two images over the pixels away from the depth map's
    discontinuities (plain PSNR without a depth map). The mask is resized
    (nearest) to the image size; NaN when nothing is left."""
    a = torch.as_tensor(np.array(a), device=device).to(torch.float64)
    b = torch.as_tensor(np.array(b), device=device).to(torch.float64)
    if a.shape != b.shape:
        raise ValueError(f"images differ in shape: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if depth is None:
        return _psnr_of(float(((a - b) ** 2).mean()), max_value)
    mask = discontinuity_mask(depth, threshold, dilate, a.device)
    if mask.shape != a.shape[:2]:
        ys = (torch.arange(a.shape[0]) * mask.shape[0]
              // a.shape[0]).clamp(0, mask.shape[0] - 1)
        xs = (torch.arange(a.shape[1]) * mask.shape[1]
              // a.shape[1]).clamp(0, mask.shape[1] - 1)
        mask = mask[ys.to(a.device)][:, xs.to(a.device)]
    keep = ~mask
    if not bool(keep.any()):
        return float("nan")
    return _psnr_of(float(((a - b)[keep] ** 2).mean()), max_value)


def compare_videos(path_a, path_b, depth=None, threshold=16, dilate=3,
                   device="cpu"):
    """Per-frame masked PSNR (dB) between two videos (AVI or MP4), over the
    shorter one's frames."""
    from .video import read_video_frames

    fa = read_video_frames(path_a)
    fb = read_video_frames(path_b)
    return [masked_psnr(fa[k], fb[k], depth, threshold, dilate,
                        device=device)
            for k in range(min(len(fa), len(fb)))]


def main(argv=None):
    from .render import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m depthrenderer_tpu_torch.evaluate",
        description="Per-frame PSNR between two rendered videos, optionally "
        "away from a depth map's discontinuities.")
    p.add_argument("video_a")
    p.add_argument("video_b")
    p.add_argument("--depth", default=None,
                   help="Depth map whose discontinuities are left out.")
    p.add_argument("--threshold", type=int, default=16)
    p.add_argument("--dilate", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where the masks and PSNRs are computed (default "
                        "cuda; raises without a card).")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    depth = None
    if args.depth:
        from . import io as dio

        depth = dio.load_depth(args.depth)
    values = compare_videos(args.video_a, args.video_b, depth,
                            args.threshold, args.dilate, device=device)
    for k, v in enumerate(values):
        log(f"frame {k:04d}: {v:.2f} dB")
    finite = [v for v in values if np.isfinite(v)]
    mean = float(np.mean(finite)) if finite else float("inf")
    log(f"mean PSNR over {len(values)} frames: {mean:.2f} dB")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
