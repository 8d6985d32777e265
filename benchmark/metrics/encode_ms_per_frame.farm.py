"""``encode_ms_per_frame.farm``: the four encoder threads' seconds (the
program span ``writer.encode``, host clock, summed over the threads) over
the frames handed to the video writers (the counter ``writer.frames``), in
thread-ms, outside the profiled job; the set-up's warm job is inside
(``benchmark/progspans.py``)."""

from benchmark import progspans


def read(run):
    return progspans.ms_per_frame(run, progspans.recorder(),
                                  "writer.encode", "writer.frames")
