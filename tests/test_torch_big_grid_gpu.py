"""The scan kernels' big_grid, edge-cull and wireframe paths on an NVIDIA GPU
against their plain PyTorch twins.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_big_grid_gpu.py

* At 1080p and mesh density 11 (the synthetic scene of ``chip_smoke.py``,
  a 2049 x 2049 grid: big_grid with a 640-column chunked march), one sway
  frame with edge cull 0.25: records, attributes (in the texture and the
  wireframe modes) and pixels, kernel against twin.
* At test_torch_gpu.py's d7 scene, 128x96: the wireframe mode on the
  standard variant at hyps 1 and 2, and ``render_clip`` with preset 4's
  knobs forced at small scale (big_grid, rmax 48, edge cull 0.25) on the
  card against the CPU.

Bars, with their reasons: the kernels compute the same float32 operations in
the same order as their twins (``--fmad=false``, ``fmaf`` where the twins
fuse), so records, attributes and pixels must be equal. Across devices the
bar is the chip smoke's: at least 99.9 % of pixels byte-identical and at
most 0.1 % off by more than 1 LSB.
"""

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import animation, transforms
from depthrenderer_tpu_torch.ops import raster_scan as rs
from depthrenderer_tpu_torch.render import clip_mvps, render_clip
from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture
from depthrenderer_tpu_torch.synthetic import synthetic_scene

from test_torch_gpu import H, N, W, scene_mesh, scene_mvps

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def pass_equal_twins(cfg, mvps, vgrid, texq, width, height, cuda):
    """Every frame of one pass, kernel against twin, in the texture and the
    wireframe modes -> each frame's (covered, wireframe-covered) share."""
    g = rs.ScanGeometry.of(width, height, vgrid.shape[0], vgrid.shape[1],
                           cfg)
    minv = rs.minv_rows(mvps)
    prep = rs.prep_scan(mvps.to(cuda), vgrid, width, height, cfg)
    shares = []
    for i in range(mvps.shape[0]):
        args = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec = rs.solve_records(*args, g, cfg)
        assert torch.equal(rec, rs.solve_records_plain(*args, g, cfg))
        margs = args + (prep.canch[i], prep.mid[i], minv[i], g, cfg)
        covered = []
        for wire in (False, True):
            attrs = rs.march_exact(rec, *margs, wire=wire)
            torch.testing.assert_close(
                attrs, rs.march_exact_plain(rec, *margs, wire=wire), rtol=0,
                atol=0, equal_nan=True)
            mode = "wireframe" if wire else "texture"
            out = rs.shade(attrs, texq, g, cfg, mode)
            assert torch.equal(out, rs.shade_plain(attrs, texq, *texq.shape,
                                                   mode))
            covered.append(float(attrs[3].mean()))
        shares.append(tuple(covered))
    return shares


def test_big_grid_1080p_d11_kernels_equal_twins(cuda):
    colour, depth = synthetic_scene()
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth, density=11)
    mesh.vertices[:, 2] *= 4.0
    n = 2049
    cfg = rs.suggest_scan_config(n, 1920, 1080, edge_cull_threshold=0.25)
    assert cfg.big_grid and cfg.cw + 128 == 640 and cfg.colfix == 1
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)[74:75]))
    proj = Camera((colour.shape[1], colour.shape[0]), fov_y=18.0).projection
    mvps = clip_mvps(proj, views, mesh.transform)
    texq = rs.pack_texture(mesh.texture.image.to(cuda))
    rs.reset_launch_counts()
    (solid, wire), = pass_equal_twins(cfg, mvps,
                                      mesh.vertices.reshape(n, n, 3).to(cuda),
                                      texq, 1920, 1080, cuda)
    assert 0.3 < solid and 0.0 < wire < solid
    assert rs.LAUNCHES == {"solve": 1, "march": 2, "shade": 2}


@pytest.mark.parametrize("hyps", [1, 2])
def test_wireframe_kernels_equal_twins(cuda, hyps):
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, hyps=hyps)
    shares = pass_equal_twins(cfg, scene_mvps(),
                              mesh.vertices.reshape(N, N, 3).to(cuda),
                              rs.pack_texture(mesh.texture.image.to(cuda)), W,
                              H, cuda)
    assert all(0.3 < s and 0.0 < w < s for s, w in shares)


def test_big_grid_render_clip_on_the_card_matches_the_cpu(cuda):
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, big_grid=True, rmax=48, colfix=1,
                                 hyps=1, sr=10, off=4, dmax=5,
                                 edge_cull_threshold=0.25)
    proj = Camera((64, 48), fov_y=18.0).projection
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)[::60]))
    rs.reset_launch_counts()
    on_card = render_clip(mesh, proj, views, W, H, config=cfg, frame_batch=2,
                          device="cuda")
    assert rs.LAUNCHES == {"solve": 5, "march": 5, "shade": 5}
    on_cpu = render_clip(mesh, proj, views, W, H, config=cfg, frame_batch=2,
                         device="cpu")
    assert on_card.shape == on_cpu.shape == (5, H, W, 4)
    diff = np.abs(on_card.astype(int) - on_cpu.astype(int)).max(axis=-1)
    assert (diff == 0).mean() >= 0.999 and (diff > 1).mean() <= 0.001
    assert (on_card[..., :3].max(axis=-1) > 0).mean() > 0.3
