"""The scan kernels' fidelity-tier paths on an NVIDIA GPU against their plain
PyTorch twins.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_tiers_gpu.py

Scene: the card-only scan tests' seeded depth map (``test_torch_gpu``),
meshed at density 7 (a 129x129 grid) and rendered at 128x96, frontal and 4
degrees yawed. Each path of the tiers runs on its own: dual-column records
(solve and march at the quality tier's pass-1 config), the colfix fan at
K = 0, 2 and 3, the ``texture_z`` shade, and sparse bands with a mixed band
flag and block gates (the patch tier's pass 2, on the transposed problem).
Bars, with their reasons: the kernels compute the same float32 operations in
the same order as their twins (``--fmad=false``), so records (on the bands a
pass renders), attributes, pixels and raster z must be equal. Across devices
(``render_clip`` of each tier on the card against the CPU) the bar is the
chip smoke's: at least 99.9 % of pixels byte-identical and at most 0.1 % off
by more than 1 LSB.
"""

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import animation, transforms
from depthrenderer_tpu_torch.ops import raster_scan as rs
from depthrenderer_tpu_torch.render import render_clip

from test_torch_gpu import H, N, W, scene_mesh, scene_mvps

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_pass(cuda, cfg, mvps, vgrid, texture, width, height, gates=None,
               raster_z=True):
    """Solve, march and texture_z shade of every frame, kernel against
    twin; ``gates`` (bflag, blkflag) makes the pass sparse; ``raster_z``
    False marches without the raster-z plane and shades in the texture
    mode, as the single pass does. -> the covered share of the kernel's
    attrs."""
    g = rs.ScanGeometry.of(width, height, vgrid.shape[0], vgrid.shape[1], cfg)
    minv = rs.minv_rows(mvps)
    prep = rs.prep_scan(mvps.to(cuda), vgrid.to(cuda), width, height, cfg)
    texq = rs.pack_texture(texture.to(cuda))
    bflag = None
    if gates is not None:
        bounds, mid = rs.apply_patch_gates(prep.bounds, prep.mid, prep.canch,
                                           gates[1].to(cuda),
                                           min(cfg.cw + 128, g.cl), g.cl)
        prep = prep._replace(bounds=bounds, mid=mid)
    covered = []
    for i in range(mvps.shape[0]):
        if gates is not None:
            bflag = gates[0][i].to(cuda)
        args = (prep.win[i], prep.w0[i], prep.bounds[i])
        rec = rs.solve_records(*args, g, cfg, bflag)
        rec_p = rs.solve_records_plain(*args, g, cfg, bflag)
        rows = slice(None) if bflag is None else bflag.bool()
        assert torch.equal(rec[rows], rec_p[rows])
        margs = (prep.win[i], prep.w0[i], prep.bounds[i], prep.canch[i],
                 prep.mid[i], minv[i], g, cfg, bflag)
        attrs = rs.march_exact(rec, *margs, raster_z=raster_z)
        assert attrs.shape[0] == rs.n_attrs(raster_z)
        torch.testing.assert_close(
            attrs, rs.march_exact_plain(rec, *margs, raster_z=raster_z),
            rtol=0, atol=0, equal_nan=True)
        if raster_z:
            out, z = rs.shade(attrs, texq, g, cfg, "texture_z", bflag)
            out_p, z_p = rs.shade_plain(attrs, texq, *texq.shape,
                                        "texture_z", bflag)
            assert torch.equal(out, out_p) and torch.equal(z, z_p)
        else:
            out = rs.shade(attrs, texq, g, cfg, "texture")
            assert torch.equal(out, rs.shade_plain(attrs, texq, *texq.shape,
                                                   "texture"))
        covered.append(float(attrs[3].mean()))
    return covered


def test_dual_col_solve_and_march_equal_twins(cuda):
    mesh = scene_mesh()
    cfg1, _ = rs.tier_configs(rs.suggest_scan_config(N, W, H, quality=True),
                              N, N, W, H)
    assert cfg1.dual_col and cfg1.colfix == 3 and cfg1.hyps == 2
    rs.reset_launch_counts()
    covered = check_pass(cuda, cfg1, scene_mvps(),
                         mesh.vertices.reshape(N, N, 3), mesh.texture.image,
                         W, H)
    assert min(covered) > 0.3
    assert rs.LAUNCHES == {"solve": 2, "march": 2, "shade": 2}


@pytest.mark.parametrize("colfix", [0, 2, 3])
def test_colfix_fans_equal_twins(cuda, colfix):
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, hyps=1, colfix=colfix)
    covered = check_pass(cuda, cfg, scene_mvps(),
                         mesh.vertices.reshape(N, N, 3), mesh.texture.image,
                         W, H)
    assert min(covered) > 0.3


def test_sparse_bands_equal_twins(cuda):
    """The patch tier's pass 2 on the transposed problem, with every other
    band flagged and a seeded block gate."""
    mesh = scene_mesh()
    cfg = rs.suggest_scan_config(N, W, H, patch=True, colfix=3)
    _, cfg2 = rs.tier_configs(cfg, N, N, W, H)
    mvps2 = rs.swap_mvps(scene_mvps())
    vgrid_t = mesh.vertices.reshape(N, N, 3).transpose(0, 1).contiguous()
    tex_t = mesh.texture.image.transpose(0, 1).contiguous()
    g2 = rs.ScanGeometry.of(H, W, N, N, cfg2)
    rng = np.random.default_rng(5)
    bflag = torch.zeros((2, g2.nbands), dtype=torch.int32)
    bflag[:, ::2] = 1
    blkflag = torch.from_numpy(rng.uniform(size=(2, g2.nbands, g2.nblk))
                               < 0.7) & bflag.bool()[..., None]
    covered = check_pass(cuda, cfg2, mvps2, vgrid_t, tex_t, H, W,
                         gates=(bflag, blkflag))
    assert min(covered) > 0.1


@pytest.mark.parametrize("tier", [dict(quality=True),
                                  dict(patch=True, colfix=3)])
def test_tiers_on_the_card_match_the_cpu(cuda, tier):
    mesh = scene_mesh()
    proj = transforms.perspective(18.0, 64 / 48)
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(300, 60.0)[::75]))
    rs.reset_launch_counts()
    on_card = render_clip(mesh, proj, views, W, H, frame_batch=2,
                          device="cuda", **tier)
    assert rs.LAUNCHES == {"solve": 8, "march": 8, "shade": 8}
    on_cpu = render_clip(mesh, proj, views, W, H, frame_batch=2,
                         device="cpu", **tier)
    assert on_card.shape == on_cpu.shape == (4, H, W, 4)
    diff = np.abs(on_card.astype(int) - on_cpu.astype(int)).max(axis=-1)
    assert (diff == 0).mean() >= 0.999 and (diff > 1).mean() <= 0.001
