"""``device_idle.frames``: the share of the traced clips' wall time in which
no kernel, copy or memset ran on the device (the union of their intervals,
``torch.profiler``), in the frames cells."""


def read(run):
    return run.trace.idle_percent() if run.trace is not None else None
