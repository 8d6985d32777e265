"""``device_idle.farm``: the share of the traced job's wall time in which
no kernel, copy or memset ran on the device (the union of their intervals,
``torch.profiler``), in the farm cell."""


def read(run):
    return run.trace.idle_percent() if run.trace is not None else None
