"""Seeded synthetic scenes: an RGBA colour image and a uint8 depth map.

The repository holds no photograph with a depth map, so every run renders
scenes drawn from its seed, in the class the port's own synthetic scene
(``depthrenderer_tpu_torch/synthetic.py``) belongs to: a colour ramp with a
16-pixel checker and Gaussian noise (sigma 6), and a depth map that is a
smooth sinusoid relief with a raised box and a near disc, within 20-240 of
255. Unlike that scene, the relief's frequencies and phases and the box's
and disc's places are drawn from the seed, so seeds vary the geometry.

The scene is made on ``device`` by one ``torch.Generator`` in a few bulk
calls, and handed to the program and to the reference as host arrays.
"""

from __future__ import annotations

import math

import torch

NOISE_SIGMA = 6.0
CHECKER = 16  # pixels a checker square


def scene_seed(seed: int, index: int) -> int:
    """The generator seed of scene ``index`` of a run seeded ``seed``."""
    return (int(seed) * 1_000_003 + int(index)) % (1 << 63)


def make_scene(seed: int, index: int, height: int, width: int,
               device="cpu"):
    """Scene ``index`` of a run seeded ``seed`` -> (colour (H, W, 4) uint8,
    depth (H, W) uint8) numpy arrays."""
    gen = torch.Generator(device=device)
    gen.manual_seed(scene_seed(seed, index))
    f64 = torch.float64
    # 9 shape parameters in [0, 1): relief x/y frequency and phase, box
    # corner, disc centre.
    u = torch.rand(9, generator=gen, dtype=f64, device=device).cpu().tolist()
    noise = torch.randn((height, width, 3), generator=gen,
                        dtype=torch.float32, device=device)
    yy = torch.arange(height, dtype=f64, device=device)[:, None]
    xx = torch.arange(width, dtype=f64, device=device)[None, :]
    checker = ((torch.div(xx, CHECKER, rounding_mode="floor")
                + torch.div(yy, CHECKER, rounding_mode="floor")) % 2) * 200 + 27
    colour = torch.stack([
        (xx / (width - 1) * 255).expand(height, width),
        (yy / (height - 1) * 255).expand(height, width),
        checker,
    ], dim=-1) + NOISE_SIGMA * noise.to(f64)
    colour = torch.clamp(torch.round(colour), 0, 255).to(torch.uint8)
    alpha = torch.full((height, width, 1), 255, dtype=torch.uint8,
                       device=device)
    colour = torch.cat([colour, alpha], dim=-1)

    fx, fy = 5.0 + 4.0 * u[0], 3.0 + 4.0 * u[1]
    px, py = 2 * math.pi * u[2], 2 * math.pi * u[3]
    depth = 110 + 60 * (torch.sin(xx / width * fx + px)
                        * torch.cos(yy / height * fy + py))
    by, bx = int((0.1 + 0.4 * u[4]) * height), int((0.1 + 0.4 * u[5]) * width)
    depth[by:by + height // 4, bx:bx + (3 * width) // 10] += 70
    cy, cx = (0.45 + 0.3 * u[6]) * height, (0.55 + 0.3 * u[7]) * width
    radius = (0.08 + 0.06 * u[8]) * height
    depth = torch.where((xx - cx) ** 2 + (yy - cy) ** 2 < radius ** 2,
                        torch.full_like(depth, 20.0), depth)
    depth = torch.clamp(torch.round(depth), 0, 255).to(torch.uint8)
    return colour.cpu().numpy(), depth.cpu().numpy()


def scene_pool(seed: int, count: int, height: int, width: int, device="cpu"):
    """The run's ``count`` scenes, in the order clips take them."""
    return [make_scene(seed, i, height, width, device) for i in range(count)]
