"""``clip_fps``: frames of every counted clip, rendered, encoded and with
the AVI closed, over all the time from the window's start to the last
clip's end (host clock)."""


def read(run):
    return run.frames_per_s
