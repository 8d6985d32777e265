"""``mesh_indices_ms``: the mean seconds of the program span
``scene.mesh_indices`` (``meshgen.grid_indices``, the triangle index list
of each mesh build), in ms (host clock), outside the profiled clips; the
set-up's warm clip is inside (``benchmark/progspans.py``)."""

from benchmark import progspans


def read(run):
    return progspans.ms_per_call(progspans.recorder(), "scene.mesh_indices")
