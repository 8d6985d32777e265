"""``idle_behind_encoder.clip``: the share of the traced clips' wall time
in which no kernel, copy or memset ran on the device and the render thread
waited on the encoder: inside the program spans ``writer.put_wait`` (a full
queue) or ``writer.drain`` (the queue draining at the clip's end), put on
the trace's clock. At most ``device_idle.clip``."""

from benchmark import progspans

SPANS = ("writer.put_wait", "writer.drain")


def read(run):
    return progspans.idle_percent_inside(run, progspans.recorder(), SPANS)
