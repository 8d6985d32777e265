"""The port's patch tier (``--patch --colfix 3``) against the JAX package's,
on the CPU.

Scene and frame bar as test_torch_scan_kernel.py (d7 grid, 128x96, frontal
and 4 degrees yawed, checker texture): PSNR >= 60 dB and at most 0.1 % of
pixels off by more than 1 LSB. The JAX side is
``render_frames_scan_patched`` built from its own pieces (pass 1 by
``_scan_rgba_z_grouped``, ``_patch_flags``, the sparse transposed pass by
``_scan_rgba_z_grouped`` with its gates, ``_merge_row_edge_raw``), both
passes at ``pack_xy=False``, the coding the port stores, and its pass-2
config as ``_patch_cfg2`` derives it. Two interpret-mode compiles.

Fed JAX's own pass-1 raster z, the port's hole flags and block gates must
equal JAX's exactly. Fed the same gates, both sparse passes must cover the
same pixels, and where they do their raster z agree within 8 float32 ulps:
XLA's CPU backend contracts the depth numerator ``w_a z_a + w_b z_b + w_c
z_c`` into fused multiply-adds that the port keeps separate (as its CUDA
kernel does), which moves the quotient by a few ulps without changing the
winner.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu.ops import raster_scan as jrs

from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs
from test_torch_scan_kernel import H, N, W, checker, frame_stats, scene
from test_torch_scan_quality import transposed_inputs

torch.set_num_threads(1)

NBANDS2, NBLOCKS2 = -(-W // 8), -(-H // 128)   # the transposed pass's grid


def jax_patch_configs():
    """(config, cfg1, cfg2) of JAX's patch pipeline at pack_xy=False."""
    cfg = dataclasses.replace(
        jrs.suggest_scan_config(N, W, H, patch=True, colfix=3), pack_xy=False)
    cfg1 = dataclasses.replace(cfg, patch=False)
    cfg2 = dataclasses.replace(jrs._patch_cfg2(cfg, N, N, W, H),
                               pack_xy=False)
    return cfg, cfg1, cfg2


@functools.lru_cache(maxsize=None)
def run_jax():
    """JAX's patched frames and its pieces: (frames, z1, gates, z2)."""
    verts, _, _, mvps = scene()
    _, cfg1, cfg2 = jax_patch_configs()
    mvps2, vgrid_t, tex_t = transposed_inputs()
    with pltpu.force_tpu_interpret_mode():
        r1, z1, _ = jrs._scan_rgba_z_grouped(
            mvps, verts.reshape(N, N, 3), checker().astype(np.float32), W, H,
            cfg1, True, 2)
        gates = jrs._patch_flags(z1, W, H, NBANDS2, NBLOCKS2)
        r2, z2, _ = jrs._scan_rgba_z_grouped(mvps2, vgrid_t, tex_t, H, W,
                                             cfg2, True, 2, gates=gates)
        raw = np.asarray(jrs._merge_row_edge_raw(r1, z1, r2, z2, W, H))
    return (jrs.unpack_raw_frames(raw, W, H), np.asarray(z1),
            tuple(np.asarray(a) for a in gates), np.asarray(z2))


def port_config():
    return convert.scan_config_from_dict(
        dataclasses.asdict(jax_patch_configs()[0]))


def test_patch_frames_match_jax():
    want, _, (bflag, _), _ = run_jax()
    verts, uvs, _, mvps = scene()
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    raw, _ = trs.render_frames_scan(
        torch.from_numpy(mvps), mesh.vertices.reshape(N, N, 3),
        mesh.texture_coordinates.reshape(N, N, 2), mesh.texture.image, W, H,
        port_config())
    got = trs.unpack_raw_frames(raw, W, H)
    p, off, n_diff = frame_stats(got, want)
    print(f"patch: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, {n_diff} pixels "
          f"differ; {int(bflag.sum())} of {bflag.size} bands flagged")
    assert p >= 60.0 and off <= 0.001
    # The sparse pass runs on some bands and skips others.
    assert bflag.any() and not bflag.all()
    t1, t2 = trs.tier_configs(port_config(), N, N, W, H)
    _, cfg1, cfg2 = jax_patch_configs()
    assert dataclasses.asdict(t1) == dataclasses.asdict(cfg1)
    assert dataclasses.asdict(t2) == dataclasses.asdict(
        dataclasses.replace(cfg2, pack_xy=True))


def test_patch_flags_and_gates_equal_jax():
    _, z1, (bflag, blkflag), _ = run_jax()
    got_b, got_k = trs.patch_flags(torch.from_numpy(z1.copy()), W, H,
                                   NBANDS2, NBLOCKS2)
    np.testing.assert_array_equal(got_b.numpy(), bflag)
    np.testing.assert_array_equal(got_k.numpy(), blkflag)
    _, _, cfg2 = jax_patch_configs()
    mvps2, vgrid_t, _ = transposed_inputs()
    win, _, bounds, canch, mid, _ = jrs._prep_scan_batched(
        jnp.asarray(mvps2), jnp.asarray(vgrid_t), H, W, cfg2)
    cl = win.shape[3]
    cwf = min(cfg2.cw + 128, cl)
    want = jrs._apply_patch_gates(bounds, mid, canch, jnp.asarray(blkflag),
                                  cwf, cl)
    got = trs.apply_patch_gates(
        *(torch.from_numpy(np.asarray(a)) for a in (bounds, mid, canch)),
        torch.from_numpy(blkflag), cwf, cl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy() == -2).any() and (got[0].numpy() == 0).any()


def test_sparse_pass_z_equals_jax_where_both_cover():
    _, z1, (bflag, blkflag), z2_jax = run_jax()
    _, _, cfg2 = jax_patch_configs()
    mvps2, vgrid_t, tex_t = transposed_inputs()
    gates = (torch.from_numpy(bflag), torch.from_numpy(blkflag))
    (_, z2), _ = trs._scan_grouped(
        torch.from_numpy(mvps2), torch.from_numpy(vgrid_t),
        torch.from_numpy(tex_t), H, W,
        convert.scan_config_from_dict(dataclasses.asdict(cfg2)), "texture_z",
        2, gates=gates)
    z2 = z2.numpy()
    far = np.float32(1.5e38)
    both = (z2 < far) & (z2_jax < far)
    ulps = np.abs(z2.view(np.int32).astype(np.int64)
                  - z2_jax.view(np.int32).astype(np.int64))[both]
    print(f"sparse pass: {int(both.sum())} pixels covered by both, "
          f"{int(((z2 < far) != (z2_jax < far)).sum())} by one; raster z "
          f"equal at {float((ulps == 0).mean()):.2%}, at most {ulps.max()} "
          f"ulps apart")
    assert both.sum() > 0
    np.testing.assert_array_equal(z2 < far, z2_jax < far)
    assert ulps.max() <= 8
    # Unflagged bands: FAR everywhere.
    rows = np.repeat(bflag == 0, 8, axis=1)
    assert (z2[rows] == np.float32(3.0e38)).all()
