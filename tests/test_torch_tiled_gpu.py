"""The tiled rasteriser's pair kernel on an NVIDIA GPU against its plain twin.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py \\
        tests/test_torch_tiled_gpu.py

Scene: the card-only scan tests' seeded depth map (``test_torch_gpu``),
meshed at density 7 (a 129x129 grid) and rendered at 128x96, frontal and 4
degrees yawed, on both routes' plane orders (Pallas: chunk, diagonal, cell
with active ranges; grid: cell, diagonal, every anchor's chunks in one list)
at 1 and 2 row anchors: the kernel on the frame group's plane tables, the
twin on the windows gathered out of them (``tiled.gather_tables``). Bars,
with their reasons: the kernel computes the
same float32 operations in the same order as ``raster_pairs_plain`` (the
kernel file is built with ``--fmad=false``, and the one contracted
multiply-add is ``fmaf`` there and an exact emulation in the twin), so the
tile rows, and the frames shaded from them in every mode, must be equal.
Across devices (``render_clip`` on the card against the plain route on the
CPU) the bar is the chip smoke's: at least 99.9 % of pixels byte-identical
and at most 0.1 % off by more than 1 LSB.
"""

import dataclasses

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import animation, transforms
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_pallas as trp
from depthrenderer_tpu_torch.ops import tiled as ttl
from depthrenderer_tpu_torch.render import render_clip

from test_torch_gpu import H, N, W, scene_mesh, scene_mvps

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, anchors):
    mesh = scene_mesh()
    mvps = scene_mvps().to(cuda)
    vg = mesh.vertices.reshape(N, N, 3).to(cuda)
    uvg = mesh.texture_coordinates.reshape(N, N, 2).to(cuda)
    cfg = trg.measured_config(mvps, vg, W, H, quantile=1.0,
                              row_anchors=anchors)
    if anchors == 2:   # narrow windows: both anchor passes do work
        cfg = dataclasses.replace(cfg, window_rows=max(8, cfg.window_rows // 2))
    return mesh, mvps, vg, uvg, cfg


@pytest.mark.parametrize("route", ["pallas", "grid"])
@pytest.mark.parametrize("anchors", [1, 2])
def test_pair_kernel_equals_plain_twin(cuda, route, anchors):
    mesh, mvps, vg, uvg, cfg = _inputs(cuda, anchors)
    if route == "pallas":
        planes = trp._prep_stage_batched(mvps, vg, uvg, W, H, cfg)
    else:
        planes = trg._grid_group(mvps, vg, uvg, W, H, cfg)
    ttl.reset_launch_counts()
    rows = ttl.raster_pairs(*planes, H, cfg)
    assert ttl.LAUNCHES == {"pairs": 1}
    plain = ttl.raster_pairs_plain(
        *ttl.gather_tables(*planes[:4], planes[4].shape[0]), *planes[4:], H,
        cfg)
    torch.cuda.synchronize()
    assert torch.equal(rows, plain)
    assert rows[..., 3].mean() > 0.3
    texture = mesh.texture.image.to(cuda)
    ntiles = -(-H // cfg.tile_h) * -(-W // cfg.tile_w)
    for mode in ("texture", "debug_z", "wireframe"):
        if route == "pallas":
            got, want = (trp._shade_stage_batched(r, texture, W, H, cfg, mode)
                         for r in (rows, plain))
        else:
            got, want = (ttl.shade_tiles(r.reshape((2, ntiles) + r.shape[1:]),
                                         texture, W, H, cfg, mode)
                         for r in (rows, plain))
        assert got.shape == (2, H, W, 4)
        assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["pallas", "grid"])
def test_render_clip_on_the_card_matches_the_cpu(cuda, impl):
    mesh = scene_mesh()
    proj = transforms.perspective(18.0, 64 / 48)
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)[::100]))
    ttl.reset_launch_counts()
    on_card = render_clip(mesh, proj, views, W, H, frame_batch=2,
                          device="cuda", impl=impl)
    assert ttl.LAUNCHES["pairs"] == 2    # one per group of 2 frames
    on_cpu = render_clip(mesh, proj, views, W, H, frame_batch=2,
                         device="cpu", impl=impl)
    assert on_card.shape == on_cpu.shape == (3, H, W, 4)
    diff = np.abs(on_card.astype(int) - on_cpu.astype(int)).max(axis=-1)
    assert (diff == 0).mean() >= 0.999 and (diff > 1).mean() <= 0.001


def test_pair_wrapper_rejects_bad_inputs(cuda):
    _, mvps, vg, uvg, cfg = _inputs(cuda, 1)
    planes = list(trp._prep_stage_batched(mvps[:1], vg, uvg, W, H, cfg))
    with pytest.raises(ValueError, match="cov must be"):
        ttl.raster_pairs(planes[0].double(), *planes[1:], H, cfg)
    with pytest.raises(ValueError, match="origin must be"):   # 64-bit
        ttl.raster_pairs(*planes[:2], planes[2].int(), *planes[3:], H, cfg)
    with pytest.raises(ValueError, match="mixed devices"):
        ttl.raster_pairs(planes[0].cpu(), *planes[1:], H, cfg)
    with pytest.raises(ValueError, match="1024 pixels"):
        ttl.raster_pairs(*planes, H, dataclasses.replace(cfg, tile_h=16))
    empty = planes[:2] + [planes[2][:0], planes[3]] + [p[:0]
                                                        for p in planes[4:]]
    assert ttl.raster_pairs(*empty, H, cfg).shape == (0, 1024, 8)
