"""The port's scan prep against the JAX package's ``_prep_scan_batched``.

The same numpy MVPs and vertex grid go into both packages. The prep's
integers (window origins, packed per-chunk scan bounds with their multi bits,
march anchors, narrow-march offsets, clipped hull rows) must be exactly equal,
and the projected window within one float32 ulp: the port rounds the
projection as XLA's CPU backend does, so it is in practice bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from depthrenderer_tpu import meshgen as jmesh
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu.ops import raster_scan as jrs
from depthrenderer_tpu.transforms import Axis

from depthrenderer_tpu_torch.ops import raster_scan as trs


def _depth(h=48, w=64, seed=0):
    """A smooth sinusoid depth map with a raised step and a noisy patch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 127 + 100 * np.sin(xx / w * 6 + seed) * np.cos(yy / h * 4)
    d[h // 3:h // 2, w // 4:w // 2] = 250
    d[h // 2:h // 2 + 6, w // 2:w // 2 + 8] = rng.integers(0, 256, (6, 8))
    return np.clip(d, 0, 255).astype(np.uint8)


def _mvps(width, height):
    base = (np.asarray(jt.perspective(18.0, width / height))
            @ np.asarray(jt.translation(dz=-10.0)))
    yaw = np.asarray(jt.rotation(np.deg2rad(4.0), axis=Axis.Y))
    return np.stack([base, base @ yaw]).astype(np.float32)  # frontal, 4 deg


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("density,width,height", [
    (3, 64, 48),      # n = 9
    (7, 256, 144),    # n = 129
    (8, 320, 240),    # n = 257: cw = 256, narrow-march offsets in play
])
def test_prep_equals_jax(density, width, height):
    verts, _, _ = jmesh.grid_mesh(_depth(), density)
    verts = np.asarray(verts).copy()
    verts[:, 2] *= 4.0
    n = 2**density + 1
    vg = verts.reshape(n, n, 3)
    mvps = _mvps(width, height)
    jcfg = jrs.suggest_scan_config(n, width, height)
    tcfg = trs.ScanConfig(**jcfg.__dict__)
    want = [np.asarray(a) for a in jrs._prep_scan_batched(
        jnp.asarray(mvps), jnp.asarray(vg), width, height, jcfg)]
    got = trs.prep_scan(torch.from_numpy(mvps), torch.from_numpy(vg), width,
                        height, tcfg)

    win_j, w0_j, bounds_j, canch_j, mid_j, ovf_j = want
    win_t = got.win.numpy()
    assert win_t.shape == win_j.shape
    assert _ulps(win_t, win_j).max() <= 1
    np.testing.assert_array_equal(got.w0.numpy(), w0_j)
    bt, bj = got.bounds.numpy(), bounds_j
    for shift, mask in ((0, 0xFFF), (12, 0xFFF), (24, 1)):  # kb, ke, multi
        np.testing.assert_array_equal((bt >> shift) & mask, (bj >> shift) & mask)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(got.canch.numpy(), canch_j)
    np.testing.assert_array_equal(got.mid.numpy(), mid_j)
    np.testing.assert_array_equal(got.overflow_rows.numpy(), ovf_j)
    # The scene exercises what the integers encode.
    assert ((bt >> 12 & 0xFFF) > (bt & 0xFFF)).any()
    if density >= 7:
        assert (bt >> 24 & 1).any()
    if jcfg.cw > 128:
        assert (mid_j >= 0).any()


def test_monotone_interp_matches_jnp():
    rng = np.random.default_rng(1)
    xp_inc = np.sort(rng.uniform(-50, 300, 40)).astype(np.float32)
    xp_inc[10] = xp_inc[11]                   # a repeated knot
    q = np.concatenate([rng.uniform(-80, 330, 30), xp_inc[:5],
                        [xp_inc[0], xp_inc[-1]]]).astype(np.float32)
    fp = np.arange(40, dtype=np.float32)
    for xp in (xp_inc, xp_inc[::-1].copy()):
        want = np.asarray(jrs._monotone_interp(q, xp, fp))
        got = trs._monotone_interp(torch.from_numpy(q)[None],
                                   torch.from_numpy(xp)[None],
                                   torch.from_numpy(fp))[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [9, 33, 129, 1025])
def test_row_mean_matches_xla(rows):
    x = (np.random.default_rng(rows).standard_normal((2, rows, 200)) * 900
         ).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda a: a.mean(axis=0)))(x))
    got = trs._xla_row_mean(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_array_equal(got, want)


def test_uv_grid_check_and_minv_rows():
    n = 9
    _, uvs, _ = jmesh.grid_mesh(np.zeros((8, 8), np.uint8), 3)
    uv = np.array(uvs).reshape(n, n, 2)
    trs.check_uv_grid(torch.from_numpy(uv))
    with pytest.raises(ValueError, match="parameterisation"):
        trs.check_uv_grid(torch.from_numpy(uv[::-1].copy()))
    mvps = _mvps(64, 48)
    minv = np.linalg.inv(mvps.astype(np.float64))
    want = np.concatenate([minv[:, 2], minv[:, 3]], axis=1).astype(np.float32)
    np.testing.assert_array_equal(trs.minv_rows(torch.from_numpy(mvps)), want)
