"""``snapshot_ms_per_job.farm``: the seconds of the program span
``batch.snapshot_read`` (a due PNG snapshot's RGBA taken on the host) over
the farm's jobs (the calls of the span ``batch.farm``), in ms (host
clock), outside the profiled job; the set-up's warm job is inside
(``benchmark/progspans.py``). A program without the spans reads None."""

from benchmark import progspans


def read(run):
    snap = progspans.recorder()
    reads = progspans.untraced(snap, "batch.snapshot_read")
    jobs = progspans.untraced(snap, "batch.farm")
    if jobs is None:
        return None
    return progspans.ms_per(reads, jobs[1])
