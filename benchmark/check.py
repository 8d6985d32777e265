"""The comparison that decides ``correct``: what the timed path delivered
against the plain reference (``reference/``).

A run keeps, from the seed, a sample of the clips its window counted
(:class:`Reservoir`) and, of each, one frame the seed picks; after the
window it renders seeded rows of those frames with the float64 reference
and compares. The numbers compared (each against the limit its workload
file states, ``check.limits``):

* ``off1_share``: the largest, over the checked frames, share of the
  reference's covered pixels on the checked rows that the program's frame
  misses by more than 1 LSB in any channel. The scan approximates by
  design (holes and wrong winners at depth edges), so this is not 0; the
  control (:func:`control_rows`) reads far above it.
* ``frames_short``: frames a counted clip should have delivered and did
  not, summed over the clips; exact, limit 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .reference import oracle
from .reference import scene as ref_scene


class Reservoir:
    """A seeded uniform sample of ``size`` clips from a stream whose length
    is known only at its end; :meth:`offer` decides before a clip runs
    whether it enters, and which kept clip it evicts."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.kept = {}   # slot -> item

    def offer(self, k: int):
        """-> the slot clip ``k`` takes (its item then replaces the slot's),
        or None."""
        if k < self.size:
            return k
        j = int(self.rng.integers(0, k + 1))
        return j if j < self.size else None

    def put(self, slot, item):
        old = self.kept.get(slot)
        self.kept[slot] = item
        return old

    def items(self):
        return [self.kept[s] for s in sorted(self.kept)]


def clip_rng(seed: int, k: int):
    return np.random.default_rng([int(seed), int(k), 0xC11])


def pick_rows(rng, height: int, count: int):
    """``count`` distinct seeded rows of a frame, ascending."""
    return sorted(int(r) for r in rng.choice(height, size=count,
                                             replace=False))


def off1_share(got, want) -> float:
    """Share of ``want``'s covered pixels (not the background) that ``got``
    misses by more than 1 LSB in any channel; an uncovered pixel of
    ``want`` that ``got`` gets wrong counts too."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    if got.shape != want.shape:
        return 1.0
    off = np.abs(got - want).max(-1) > 1
    covered = want[..., :3].max(-1) > 0
    return float(off.sum() / max(int(covered.sum()), 1))


@dataclass
class Reference:
    """The reference's view of a run: the configuration and the scenes the
    clips took, on ``device``."""

    config: dict
    scenes: list
    device: str
    _grids: dict = field(default_factory=dict)

    def grid(self, scene_index: int):
        if scene_index not in self._grids:
            self._grids.clear()
            c = self.config
            depth = self.scenes[scene_index][1]
            self._grids[scene_index] = ref_scene.grid(
                depth, c["mesh_density"], c["displacement_factor"],
                self.device)
        return self._grids[scene_index]

    def rows(self, scene_index: int, frame: int, rows,
             precision: str = "float64"):
        """(len(rows), W, 4) uint8 numpy: the reference's pixels."""
        c = self.config
        vgrid, uvgrid = self.grid(scene_index)
        mvp = ref_scene.mvp(frame, c["fps"], c["fov_y"], c["width"],
                            c["height"])
        colour = torch.as_tensor(self.scenes[scene_index][0],
                                 device=self.device)
        out = oracle.render_rows(mvp, vgrid, uvgrid, colour, c["width"],
                                 c["height"], rows,
                                 c.get("edge_cull_threshold"), precision)
        return out.cpu().numpy()


def control_rows(ref: Reference, scene_index: int, frame: int, rows):
    """The control: the reference computed one precision step below the
    program's (float32 with TF32 products, :mod:`.reference.oracle`), put
    in the program's place."""
    return ref.rows(scene_index, frame, rows, precision="tf32")


@dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def judge(values: dict, limits: dict):
    """-> [Compared] in ``limits``' order; a number without a limit, or a
    limit without a number, is an error of the workload file."""
    if set(values) != set(limits):
        raise KeyError(f"numbers {sorted(values)} and limits {sorted(limits)} "
                       f"of the workload file differ")
    return [Compared(name, float(values[name]), float(limits[name]))
            for name in limits]
