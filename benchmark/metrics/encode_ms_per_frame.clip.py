"""``encode_ms_per_frame.clip``: the encoder thread's seconds (the program
span ``writer.encode``, host clock) over the frames handed to the video
writer (the counter ``writer.frames``), in ms, outside the profiled clips;
the set-up's warm clip is inside (``benchmark/progspans.py``)."""

from benchmark import progspans


def read(run):
    return progspans.ms_per_frame(run, progspans.recorder(),
                                  "writer.encode", "writer.frames")
