"""``readback_ms_per_frame``: device time of the device-to-host copies in
the traced clips over the frames they rendered (``torch.profiler``)."""


def read(run):
    tr = run.trace
    if tr is None or tr.frames == 0:
        return None
    from benchmark.devtrace import COPY

    seconds = sum(e - s for s, e in tr.intervals((COPY,), name_has="DtoH"))
    return 1e3 * seconds / tr.frames if seconds > 0 else None
