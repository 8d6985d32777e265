"""``dispatch_ms_per_frame``: the seconds of the program span
``render.dispatch`` (each frame group's prep, kernels and readback queued
by the host) over the frames ``render_clip`` delivered (the counter
``render.frames``), in ms (host clock), outside the profiled clips; the
set-up's warm clip is inside (``benchmark/progspans.py``)."""

from benchmark import progspans


def read(run):
    return progspans.ms_per_frame(run, progspans.recorder(),
                                  "render.dispatch", "render.frames")
