"""``farm_dispatch_ms_per_frame``: the seconds of the program span
``batch.dispatch`` (each chunk's sharded render, YUV pack and copies queued
by the host) over the model-frames the farm handed to its writers (the
counter ``batch.frames``), in ms (host clock), outside the profiled job; the
set-up's warm job is inside (``benchmark/progspans.py``). A program without
the span reads None."""

from benchmark import progspans


def read(run):
    return progspans.ms_per_frame(run, progspans.recorder(),
                                  "batch.dispatch", "batch.frames")
