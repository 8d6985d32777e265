"""The port's quality tier (``--quality``) against the JAX package's, on the
CPU.

Scene and frame bar as test_torch_scan_kernel.py (d7 grid, 128x96, frontal
and 4 degrees yawed, checker texture): PSNR >= 60 dB and at most 0.1 % of
pixels off by more than 1 LSB, for the merged frames and for pass 1's. The
JAX side is ``render_frames_scan_quality`` in its texture form, built from
its own pieces (``_scan_rgba_z_grouped`` per pass in Pallas interpret mode,
``_merge_row_edge_raw``) so that both passes run at ``pack_xy=False``, the
strip coding the port stores. Both passes' configs are the ones JAX's
``render_frames_scan_quality`` derives (:func:`jax_tier_configs`). Two
interpret-mode compiles, one per pass.

Also here, each exact: the tier configs the port derives
(``tier_configs``), the transposed pass's MVPs and prep integers, both
depth merges on seeded arrays, and the oracle bar of test_torch_scan_kernel
(the port's flips against ``raster_reference`` at most JAX's plus 0.1
percentage points).
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu.ops import raster_reference
from depthrenderer_tpu.ops import raster_scan as jrs

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs
from test_torch_scan_kernel import H, N, W, checker, frame_stats, scene

torch.set_num_threads(1)


def jax_tier_configs(config):
    """(cfg1, cfg2): the configs JAX's ``render_frames_scan_quality`` hands
    its two passes for ``config`` on this scene. Its pass function is
    replaced by a stub that records each config (and returns blank pass-1
    outputs), so nothing renders."""
    seen = []

    class Recorded(Exception):
        pass

    def stub(mvps, vertex_grid, texture_f32, width, height, cfg, *args,
             **kwargs):
        seen.append(cfg)
        if len(seen) == 2:
            raise Recorded
        shape = (len(mvps), -(-height // 8) * 8, -(-width // 128) * 128)
        return jnp.zeros(shape, jnp.uint32), jnp.zeros(shape, jnp.float32), 0

    verts, uvs, _, mvps = scene()
    with mock.patch.object(jrs, "_scan_rgba_z_grouped", stub):
        try:
            jrs.render_frames_scan_quality(
                mvps[:1], verts.reshape(N, N, 3), uvs.reshape(N, N, 2),
                checker().astype(np.float32), W, H, config, interpret=True)
        except Recorded:
            pass
    assert len(seen) == 2
    return tuple(seen)


def jax_quality_configs():
    """(config, cfg1, cfg2) of JAX's quality pipeline: cfg1 and cfg2 are
    what JAX's own ``render_frames_scan_quality`` derives for ``config`` and
    hands its passes (:func:`jax_tier_configs`, no copy of its derivation),
    pass 2 then set to pack_xy=False (pass 1 inherits it from ``config``)."""
    cfg = dataclasses.replace(jrs.suggest_scan_config(N, W, H, quality=True),
                              pack_xy=False)
    cfg1, cfg2 = jax_tier_configs(cfg)
    return cfg, cfg1, dataclasses.replace(cfg2, pack_xy=False)


def transposed_inputs():
    """(mvps2, transposed grid, transposed texture) as JAX makes them."""
    verts, _, _, mvps = scene()
    S = np.asarray(jrs._ROW_EDGE_SWAP, np.float64)
    mvps2 = np.einsum("ij,tjk->tik", S,
                      mvps.astype(np.float64)).astype(np.float32)
    vgrid_t = np.ascontiguousarray(verts.reshape(N, N, 3).transpose(1, 0, 2))
    tex_t = np.ascontiguousarray(checker().astype(np.float32).transpose(
        1, 0, 2))
    return mvps2, vgrid_t, tex_t


@functools.lru_cache(maxsize=None)
def run_jax():
    """JAX's quality frames (T, H, W, 4) uint8, its passes' raster z and
    pass 1's packed pixels."""
    verts, _, _, mvps = scene()
    _, cfg1, cfg2 = jax_quality_configs()
    mvps2, vgrid_t, tex_t = transposed_inputs()
    with pltpu.force_tpu_interpret_mode():
        r1, z1, _ = jrs._scan_rgba_z_grouped(
            mvps, verts.reshape(N, N, 3), checker().astype(np.float32), W, H,
            cfg1, True, 2)
        r2, z2, _ = jrs._scan_rgba_z_grouped(mvps2, vgrid_t, tex_t, H, W,
                                             cfg2, True, 2)
        raw = np.asarray(jrs._merge_row_edge_raw(r1, z1, r2, z2, W, H))
    return (jrs.unpack_raw_frames(raw, W, H), np.asarray(z1), np.asarray(z2),
            np.asarray(r1))


@functools.lru_cache(maxsize=None)
def run_port():
    verts, uvs, _, mvps = scene()
    cfg = convert.scan_config_from_dict(
        dataclasses.asdict(jax_quality_configs()[0]))
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    raw, _ = trs.render_frames_scan(
        torch.from_numpy(mvps), mesh.vertices.reshape(N, N, 3),
        mesh.texture_coordinates.reshape(N, N, 2), mesh.texture.image, W, H,
        cfg)
    return trs.unpack_raw_frames(raw, W, H)


def test_tier_configs_equal_jax():
    cfg, cfg1, cfg2 = jax_quality_configs()
    assert cfg.row_edge and cfg1.dual_col and cfg1.colfix == 3
    t1, t2 = trs.tier_configs(convert.scan_config_from_dict(
        dataclasses.asdict(cfg)), N, N, W, H)
    assert dataclasses.asdict(t1) == dataclasses.asdict(cfg1)
    assert dataclasses.asdict(t2) == dataclasses.asdict(
        dataclasses.replace(cfg2, pack_xy=True))   # JAX's own pass-2 coding


def test_quality_frames_match_jax():
    want, z1, z2, _ = run_jax()
    got = run_port()
    p, off, n_diff = frame_stats(got, want)
    won = int((z2[:, :W, :H].transpose(0, 2, 1) < z1[:, :H, :W]).sum())
    print(f"quality: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, {n_diff} pixels "
          f"differ; pass 2 wins {won} pixels in JAX's merge")
    assert got.shape == want.shape == (2, H, W, 4)
    assert p >= 60.0 and off <= 0.001
    assert won > 0   # the transposed pass contributes


def test_quality_pass1_frames_match_jax():
    """Pass 1 alone (dual-column records, hyps 2, colfix 3) in the texture_z
    mode: pixels at the frame bar, covered pixels equal."""
    _, z1_jax, _, r1_jax = run_jax()
    verts, uvs, _, mvps = scene()
    _, cfg1, _ = jax_quality_configs()
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    (r1, z1), _ = trs._scan_grouped(
        torch.from_numpy(mvps), mesh.vertices.reshape(N, N, 3),
        mesh.texture.image, W, H,
        convert.scan_config_from_dict(dataclasses.asdict(cfg1)), "texture_z",
        2)
    got = trs.unpack_raw_frames(r1, W, H)
    want = jrs.unpack_raw_frames(r1_jax, W, H)
    p, off, n_diff = frame_stats(got, want)
    far = np.float32(1.5e38)
    cov, cov_jax = z1.numpy() < far, z1_jax < far
    print(f"quality pass 1: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, {n_diff} "
          f"pixels differ, coverage differs at {int((cov != cov_jax).sum())}")
    assert got.shape == want.shape == (2, H, W, 4)
    assert p >= 60.0 and off <= 0.001
    assert (cov != cov_jax).mean() <= 0.001


def test_transposed_prep_equals_jax():
    _, _, cfg2 = jax_quality_configs()
    _, _, _, mvps = scene()
    mvps2, vgrid_t, _ = transposed_inputs()
    port_m2 = trs.swap_mvps(torch.from_numpy(mvps))
    np.testing.assert_array_equal(port_m2.numpy(), mvps2)
    want = [np.asarray(a) for a in jrs._prep_scan_batched(
        jnp.asarray(mvps2), jnp.asarray(vgrid_t), H, W, cfg2)]
    vg = torch.from_numpy(np.ascontiguousarray(
        scene()[0].reshape(N, N, 3))).transpose(0, 1).contiguous()
    got = trs.prep_scan(port_m2, vg, H, W, convert.scan_config_from_dict(
        dataclasses.asdict(cfg2)))
    for name, a, b in zip(("w0", "bounds", "canch", "mid", "overflow"),
                          [got.w0, got.bounds, got.canch, got.mid,
                           got.overflow_rows], want[1:]):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      b.astype(np.int64), err_msg=name)
    ulps = np.abs(got.win.numpy().view(np.int32).astype(np.int64)
                  - want[0].view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_merges_equal_jax():
    rng = np.random.default_rng(3)
    T, wd, ht = 2, 100, 70                       # original image W x H
    h8, wl1 = 72, 128                             # pass 1 raw layout
    h82, wl2 = 104, 128                           # pass 2 (transposed)
    r1 = rng.integers(-2**31, 2**31, (T, h8, wl1)).astype(np.int32)
    r2 = rng.integers(-2**31, 2**31, (T, h82, wl2)).astype(np.int32)
    z1 = rng.uniform(-1, 1, (T, h8, wl1)).astype(np.float32)
    z2 = rng.uniform(-1, 1, (T, h82, wl2)).astype(np.float32)
    z1[:, ::5] = np.float32(3.0e38)
    z2[:, :, ::7] = np.float32(3.0e38)
    z2[:, 3, 4] = z1[:, 4, 3]                     # exact ties keep pass 1
    want = np.asarray(jrs._merge_row_edge_raw(
        r1.view(np.uint32), z1, r2.view(np.uint32), z2, wd, ht))
    got = trs.merge_row_edge_raw(*(torch.from_numpy(a) for a in
                                   (r1, z1, r2, z2)), wd, ht)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The attrs merge: JAX's (T, nb, 8 ch, 8, WL) bands, the port's first 5
    # channels as (T, 5, HPAD, WL) planes.
    b1 = rng.uniform(0, 1, (T, h8 // 8, 8, 8, wl1)).astype(np.float32)
    b2 = rng.uniform(0, 1, (T, h82 // 8, 8, 8, wl2)).astype(np.float32)
    b1[:, :, 3] = b1[:, :, 3] > 0.3
    b2[:, :, 3] = b2[:, :, 3] > 0.5

    def planes(b):
        return torch.from_numpy(np.ascontiguousarray(
            b.transpose(0, 2, 1, 3, 4).reshape(T, 8, -1, b.shape[-1])[:, :5]))

    want = np.asarray(jrs._merge_row_edge(b1, b2, wd, ht))
    got = trs.merge_row_edge(planes(b1), planes(b2), wd, ht)
    np.testing.assert_array_equal(got.numpy(), planes(want).numpy())
    assert 0 < int((got[:, 0] != planes(b1)[:, 0]).sum())


def test_quality_oracle_flips_no_worse_than_jax():
    want, _, _, _ = run_jax()
    got = run_port()
    verts, uvs, idx, mvps = scene()
    ref = raster_reference.rasterize_reference(verts, uvs, idx, mvps[1],
                                               checker(), W, H)

    def flips(img):
        return float((np.abs(img.astype(int) - ref.astype(int)).max(-1)
                      > 8).mean())

    f_port, f_jax = flips(got[1]), flips(want[1])
    print(f"quality oracle flips: port {f_port:.4%}, JAX {f_jax:.4%}")
    assert f_port <= f_jax + 0.001
