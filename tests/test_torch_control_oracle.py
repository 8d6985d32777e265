"""The lossless control and the float64 row oracle, against the JAX
package's control and its numpy oracle, on the CPU.

``render_frame_grid_exact`` (the control) renders a frame in strips through
the grid route. At BASELINE preset 4 (4K, mesh density 12) its frame moves
with its strip count on the card. This file holds, at a size where every
renderer runs on the CPU, the port's control and the JAX package's against
the JAX package's numpy oracle at two strip counts, and the oracle that the
card checks preset 4 against (``ops/raster_reference.rasterize_grid_rows``)
against that numpy oracle.

Scene: the chip smoke's synthetic generator at preset 4's proportions cut
to 128x72 (texture as wide as the frame, about one grid cell per pixel),
mesh density 6, depth displacement 4, fov_y 18, the sway's frame 0, with and
without preset 4's edge cull (0.25).

Bars, with their reasons:

* The row oracle against the JAX oracle (``raster_reference``): both are
  float64 with the same formulas, so at most 1 LSB (a rounding tie) and at
  least 99.9 % of pixels identical.
* The controls at 1 and 4 strips: the port's against JAX's at the tiled
  tests' bar (>= 60 dB, <= 0.2 % of pixels > 1 LSB); each against the oracle,
  and the port's at 1 strip against its own at 4, <= 0.1 % > 1 LSB: at this
  size the control is lossless.
"""

import functools

import numpy as np
import pytest
import torch

from depthrenderer_tpu.ops import raster_grid as jrg
from depthrenderer_tpu.ops import raster_reference as jref
from depthrenderer_tpu.utils import psnr

from depthrenderer_tpu_torch import animation, transforms
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_reference as tref
from depthrenderer_tpu_torch.render import clip_mvps
from depthrenderer_tpu_torch.scene import Camera, Mesh, Texture
from depthrenderer_tpu_torch.synthetic import synthetic_scene

torch.set_num_threads(1)

W, H, DENSITY, CULL = 128, 72, 6, 0.25


@functools.lru_cache(maxsize=None)
def preset4_scene():
    """(mvp (4, 4), vertex grid, uv grid, texture (H, W, 4) uint8)."""
    colour, depth = synthetic_scene(h=H, w=W)
    mesh = Mesh.from_texture(Texture(colour), depth_map=depth,
                             density=DENSITY)
    mesh.vertices[:, 2] *= 4.0
    n = 2**DENSITY + 1
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(1, 60.0)))
    mvp = clip_mvps(Camera((W, H), fov_y=18.0).projection, views,
                    mesh.transform)[0]
    return (mvp, mesh.vertices.reshape(n, n, 3),
            mesh.texture_coordinates.reshape(n, n, 2), mesh.texture.image)


@functools.lru_cache(maxsize=None)
def jax_oracle(cull):
    mvp, vg, uvg, tex = preset4_scene()
    n = vg.shape[0]
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = i * n + j
    b = a + n
    tris = np.stack([a, b, a + 1, a + 1, b, b + 1], -1).reshape(-1)
    return jref.rasterize_reference(
        vg.numpy().reshape(-1, 3), uvg.numpy().reshape(-1, 2), tris,
        mvp.numpy(), np.asarray(tex), W, H, edge_cull_threshold=cull)


def off_share(a, b, lsb=1):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
    return float((diff > lsb).mean())


@pytest.mark.parametrize("cull", [None, CULL], ids=["no-cull", "cull"])
def test_oracle_rows_equal_jax_oracle(cull):
    mvp, vg, uvg, tex = preset4_scene()
    got = tref.rasterize_grid_rows(mvp, vg, uvg, tex, W, H, range(H),
                                   cull).numpy()
    want = jax_oracle(cull)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    assert got.shape == want.shape == (H, W, 4)
    assert (want[..., :3].max(-1) > 0).mean() > 0.5
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    rows = [0, 17, 40, 71]
    part = tref.rasterize_grid_rows(mvp, vg, uvg, tex, W, H, rows,
                                    cull).numpy()
    np.testing.assert_array_equal(part, got[rows])


@pytest.mark.parametrize("cull", [None, CULL], ids=["no-cull", "cull"])
def test_controls_equal_oracle_at_two_strip_counts(cull):
    mvp, vg, uvg, tex = preset4_scene()
    oracle = jax_oracle(cull)
    port = {}
    for strips in (1, 4):
        port[strips] = trg.render_frame_grid_exact(
            mvp, vg, uvg, tex, W, H, strips=strips, edge_cull_threshold=cull)
        want = np.asarray(jrg.render_frame_grid_exact(
            mvp.numpy(), vg.numpy(), uvg.numpy(),
            np.asarray(tex, np.float32), W, H, strips=strips,
            edge_cull_threshold=cull))
        assert psnr(port[strips], want) >= 60.0
        assert off_share(port[strips], want) <= 0.002
        assert off_share(port[strips], oracle) <= 0.001, strips
        assert off_share(want, oracle) <= 0.001, strips
    assert off_share(port[1], port[4]) <= 0.001
