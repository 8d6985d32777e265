"""The quality tier's wireframe mode (``--quality --mode wireframe``) against
the JAX package's, on the CPU.

Scene and bar as test_torch_scan_quality.py (d7 grid, 128x96, frontal and 4
degrees yawed, checker texture): PSNR >= 60 dB and at most 0.1 % of pixels
off by more than 1 LSB. The JAX side is ``render_frames_scan_quality`` in
its attrs form, built from its own pieces as that test builds the texture
form: ``_scan_attrs_grouped`` per pass in Pallas interpret mode (each pass's
attrs carry the winner's normalised least barycentric weight,
``bml / bar``), ``_merge_row_edge`` over all channels by raster z, then
``_shade_scan_batched`` in the wireframe mode (``common.shade`` tests
``min_lam <= 0.15`` after the merge). Both passes at ``pack_xy=False``, the
strip coding the port stores. Two interpret-mode compiles of the attrs
kernel, one per pass (about four minutes alone), so this file stands apart
for ``--dist loadfile``.

Also here: the attrs merge carrying the sixth plane, exact against JAX's on
seeded arrays; the march's sixth plane against the fifth-plane march (the
same attributes, coverage left ungated); and the CLI's ``--quality --mode
wireframe`` end to end on the CPU.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu
from depthrenderer_tpu.ops import common as jcommon
from depthrenderer_tpu.ops import raster_scan as jrs

from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch.ops import raster_scan as trs
from test_torch_scan_kernel import H, N, W, checker, frame_stats, scene
from test_torch_scan_quality import jax_quality_configs, transposed_inputs
from test_torch_slice import write_png_pair

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def run_jax():
    """JAX's quality wireframe frames (T, H, W, 4) uint8 and its merged
    attrs (T, nbands, 8 ch, 8, WL)."""
    verts, _, _, mvps = scene()
    _, cfg1, cfg2 = jax_quality_configs()
    mvps2, vgrid_t, _ = transposed_inputs()
    with pltpu.force_tpu_interpret_mode():
        b1, _ = jrs._scan_attrs_grouped(mvps, verts.reshape(N, N, 3), W, H,
                                        cfg1, True, 2)
        b2, _ = jrs._scan_attrs_grouped(mvps2, vgrid_t, H, W, cfg2, True, 2)
        merged = jrs._merge_row_edge(b1, b2, W, H)
        frames = jrs._shade_scan_batched(
            merged, checker().astype(np.float32), W, H, "wireframe")
    return np.asarray(frames), np.asarray(merged)


@functools.lru_cache(maxsize=None)
def run_port():
    verts, uvs, _, mvps = scene()
    cfg = convert.scan_config_from_dict(
        dataclasses.asdict(jax_quality_configs()[0]))
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    raw, _ = trs.render_frames_scan(
        torch.from_numpy(mvps), mesh.vertices.reshape(N, N, 3),
        mesh.texture_coordinates.reshape(N, N, 2), mesh.texture.image, W, H,
        cfg, "wireframe")
    return trs.unpack_raw_frames(raw, W, H)


def test_quality_wireframe_frames_match_jax():
    want, merged = run_jax()
    got = run_port()
    p, off, n_diff = frame_stats(got, want)
    # JAX's covered pixels of the merge, and those its wire test keeps.
    full = merged.transpose(0, 1, 3, 2, 4).reshape(2, -1, 8, merged.shape[-1])
    cov = full[:, :H, 3, :W] > 0.5
    wire = cov & (full[:, :H, 5, :W] <= jcommon.WIREFRAME_EDGE_THRESHOLD)
    print(f"quality wireframe: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, {n_diff} "
          f"pixels differ; JAX keeps {int(wire.sum())} of {int(cov.sum())} "
          f"covered pixels")
    assert got.shape == want.shape == (2, H, W, 4)
    assert p >= 60.0 and off <= 0.001
    assert 0 < int(wire.sum()) < int(cov.sum())   # edges kept, faces not


def test_merge_carries_the_sixth_plane_as_jax():
    """The attrs merge on seeded 8-channel bands: the port's six planes
    against JAX's channels 0-5, exact; u and v swap for pass-2 winners,
    the least barycentric weight does not."""
    rng = np.random.default_rng(5)
    T, wd, ht = 2, 100, 70
    b1 = rng.uniform(0, 1, (T, 9, 8, 8, 128)).astype(np.float32)
    b2 = rng.uniform(0, 1, (T, 13, 8, 8, 128)).astype(np.float32)
    b1[:, :, 3] = b1[:, :, 3] > 0.3
    b2[:, :, 3] = b2[:, :, 3] > 0.5

    def planes(b):
        return torch.from_numpy(np.ascontiguousarray(
            b.transpose(0, 2, 1, 3, 4).reshape(T, 8, -1, b.shape[-1])[:, :6]))

    want = planes(np.asarray(jrs._merge_row_edge(b1, b2, wd, ht)))
    got = trs.merge_row_edge(planes(b1), planes(b2), wd, ht)
    assert got.shape[1] == 6
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    won = got[:, 5, :ht, :wd] != planes(b1)[:, 5, :ht, :wd]
    assert int(won.sum()) > 0
    # The one wire test after the merge: JAX's common.shade comparison.
    gated = trs.wire_coverage(got)
    keep = (want[:, 3] > 0.5) & (want[:, 5] <= np.float32(
        jcommon.WIREFRAME_EDGE_THRESHOLD))
    np.testing.assert_array_equal(gated[:, 3].numpy(), keep.float().numpy())
    np.testing.assert_array_equal(gated[:, [0, 1, 2, 4]].numpy(),
                                  got[:, [0, 1, 2, 4]].numpy())


def test_sixth_plane_march_keeps_the_fifth_plane_march():
    """The attrs march with the sixth plane: planes 0-4 equal the raster-z
    march's, coverage ungated; the sixth is 0 where uncovered and in
    [0, 1/3] where covered (the least of three weights that sum to 1, up to
    rounding)."""
    verts, uvs, _, mvps = scene()
    _, cfg1, _ = jax_quality_configs()
    cfg = convert.scan_config_from_dict(dataclasses.asdict(cfg1))
    mesh = convert.scene_from_numpy(verts, uvs, checker())
    vg = mesh.vertices.reshape(N, N, 3)
    g = trs.ScanGeometry.of(W, H, N, N, cfg)
    p = trs.prep_scan(torch.from_numpy(mvps[1:]), vg, W, H, cfg)
    minv = trs.minv_rows(torch.from_numpy(mvps[1:]))
    args = (p.win[0], p.w0[0], p.bounds[0])
    rec = trs.solve_records(*args, g, cfg)
    margs = (rec, *args, p.canch[0], p.mid[0], minv[0], g, cfg)
    five = trs.march_exact(*margs, raster_z=True)
    six = trs.march_exact(*margs, min_lam=True)
    assert six.shape == (6,) + five.shape[1:]
    assert torch.equal(six[:5], five)
    cov = six[3] > 0.5
    assert torch.all(six[5][~cov] == 0)
    assert torch.all((six[5][cov] >= 0) & (six[5][cov] <= 0.34))
    with pytest.raises(ValueError):
        trs.march_exact(*margs, wire=True, min_lam=True)


def test_cli_quality_wireframe_renders(tmp_path):
    cp, dp = write_png_pair(tmp_path)
    out = tmp_path / "out"
    assert tcli.main([str(cp), str(dp), "--device", "cpu", "-mesh-density",
                      "5", "--width", "64", "--height", "48", "--frames", "2",
                      "--codec", "DIB ", "--quality", "--mode", "wireframe",
                      "-output-path", str(out)]) == 0
    from depthrenderer_tpu_torch.video import read_avi_frames

    frames = read_avi_frames(out / f"{cp.name}.avi")
    assert len(frames) == 2 and frames[0].shape == (48, 64, 3)
    lit = (frames[0] > 0).any(-1)
    assert 0 < lit.mean() < 1   # the edge bands, not the filled faces
