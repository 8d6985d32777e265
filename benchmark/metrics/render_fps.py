"""``render_fps``: frames delivered to the consumer, every counted clip's
mesh build included, over all the time from the window's start to the last
clip's end (host clock)."""


def read(run):
    return run.frames_per_s
