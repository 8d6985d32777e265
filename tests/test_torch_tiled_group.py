"""The tiled routes' frame groups on the CPU: a group's prep is its frames'
preps one after another, and no pixel depends on the group size.

Each route builds its frames' plane tables into one (F, 12, N) tensor and
places every window in them by a table origin with the frame's offset
``f * 12 * N`` folded in; the CPU twin gathers the windows back out frame
after frame (``tiled.gather_tables``, ``gather_frames``). Here, on the
card-only tests' seeded scene (``test_torch_gpu``) at density 5 (a 33x33
grid), 64x48, three views (frontal, 4 and -3 degrees yawed) at 1 and 2 row
anchors: the group prep (Pallas route ``_prep_stage_batched``, grid route
``_grid_group``) must equal the per-frame preps concatenated exactly, the
origins shifted by the frame offsets, and both routes' frames at
``frame_batch=16`` must equal those at ``frame_batch=1`` byte for byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch import transforms
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_pallas as trp

from test_torch_gpu import scene_mesh

torch.set_num_threads(1)

W, H, DENSITY = 64, 48, 5
N = 2**DENSITY + 1


def inputs(anchors):
    mesh = scene_mesh(density=DENSITY)
    base = transforms.matmul(transforms.perspective(18.0, W / H),
                             transforms.translation(dz=-15.0))
    mvps = torch.stack([transforms.matmul(base, transforms.rotation(
        torch.tensor(np.deg2rad(a), dtype=torch.float32),
        axis=transforms.Axis.Y)) for a in (0.0, 4.0, -3.0)])
    vg = mesh.vertices.reshape(N, N, 3)
    uvg = mesh.texture_coordinates.reshape(N, N, 2)
    cfg = trg.measured_config(mvps, vg, W, H, quantile=1.0,
                              row_anchors=anchors)
    if anchors == 2:   # narrow windows: both anchor passes do work
        cfg = dataclasses.replace(cfg,
                                  window_rows=max(8, cfg.window_rows // 2))
    return mesh, mvps, vg, uvg, cfg


@pytest.mark.parametrize("anchors", [1, 2])
@pytest.mark.parametrize("route", ["pallas", "grid"])
def test_group_prep_is_frame_preps_concatenated(route, anchors):
    _, mvps, vg, uvg, cfg = inputs(anchors)
    prep = trp._prep_stage_batched if route == "pallas" else trg._grid_group
    group = prep(mvps, vg, uvg, W, H, cfg)
    frames = [prep(mvps[i:i + 1], vg, uvg, W, H, cfg)
              for i in range(len(mvps))]
    assert len(group) == 8
    per_frame = frames[0][0].numel()   # 12 * N: a frame's table offset
    for k, got in enumerate(group):
        if k == 3:   # rel: one for the route
            want = frames[0][k]
        else:
            want = torch.cat([f[k] + (i * per_frame if k == 2 else 0)
                              for i, f in enumerate(frames)])
        assert got.dtype == want.dtype and torch.equal(got, want), k


@pytest.mark.parametrize("anchors", [1, 2])
@pytest.mark.parametrize("route", ["pallas", "grid"])
def test_frames_do_not_depend_on_frame_batch(route, anchors):
    mesh, mvps, vg, uvg, cfg = inputs(anchors)
    render = (trp.render_frames_pallas if route == "pallas"
              else trg.render_frames_grid)
    args = (mvps, vg, uvg, mesh.texture.image, W, H, cfg)
    grouped = render(*args, frame_batch=16)
    single = render(*args, frame_batch=1)
    assert grouped.shape == (len(mvps), H, W, 4)
    assert torch.equal(grouped, single)
    assert (grouped[..., :3] > 0).any(-1).float().mean() > 0.3


@pytest.mark.parametrize("route", ["pallas", "grid"])
def test_plane_slabs_equal_whole_frames(route, monkeypatch):
    """A grid past ``raster_grid.PREP_CELLS`` cells has its planes built in
    slabs of cell rows, one frame at a time (d13 on the card): the tables
    equal those built whole, several frames at once."""
    _, mvps, vg, uvg, cfg = inputs(2)
    prep = trp._prep_stage_batched if route == "pallas" else trg._grid_group
    whole = prep(mvps, vg, uvg, W, H, cfg)
    monkeypatch.setattr(trg, "PREP_CELLS", 300)   # slabs of 9 cell rows
    assert len(trg.prep_batches(len(mvps), N, N, cfg)[0][1]) == 4
    for got, want in zip(prep(mvps, vg, uvg, W, H, cfg), whole):
        assert torch.equal(got, want)
