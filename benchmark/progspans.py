"""The program's own spans and counters for the metrics: the recorder of
``depthrenderer_tpu_torch.profiling`` (totals and counters always on; spans
kept one by one while the profiler is on), and its host times put on the
clock of the run's trace.

The host-clock ratios cover the run's clips outside the ``--trace 1``
window (the recorder's totals less the spans kept in the traced clips, and
the frames less the traced frames): the profiler slows the host there. They
still hold the set-up's warm clip, which the recorder does not tell apart.

A program without the recorder (an older tree run with these files) reads
None here, and so does every metric built on it.
"""

from __future__ import annotations

import statistics

from .devtrace import merged

CLIP_SPAN = "bench.clip"
DROPPED = "profiling.dropped"   # the recorder's count of spans not kept


def recorder():
    """The program's recorder snapshot, or None where it has none."""
    from depthrenderer_tpu_torch import profiling

    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def span_total(snap, name):
    """-> (seconds, calls) of the program span ``name``, or None."""
    if snap is None or name not in snap["spans"]:
        return None
    total = snap["spans"][name]
    return total["seconds"], total["calls"]


def counter(snap, name) -> int:
    return 0 if snap is None else int(snap["counters"].get(name, 0))


def untraced(snap, name):
    """-> (seconds, calls) of the program span ``name`` outside the traced
    clips: its totals less its kept spans; None where it was not recorded
    or a kept span was dropped (the totals could not be split)."""
    total = span_total(snap, name)
    if total is None or counter(snap, DROPPED):
        return None
    kept = [s.end_ns - s.start_ns for s in snap["kept"] if s.name == name]
    return total[0] - 1e-9 * sum(kept), total[1] - len(kept)


def traced_frames(run) -> int:
    return 0 if run.trace is None else run.trace.frames


def ms_per(seconds_calls, n):
    """1e3 x the seconds of ``seconds_calls`` (:func:`untraced`) over
    ``n``; None when nothing was recorded or ``n`` is not positive."""
    if seconds_calls is None or n <= 0:
        return None
    return 1e3 * seconds_calls[0] / n


def ms_per_call(snap, span):
    """The program span ``span``'s mean ms a call outside the traced
    clips."""
    seconds_calls = untraced(snap, span)
    return ms_per(seconds_calls,
                  0 if seconds_calls is None else seconds_calls[1])


def ms_per_frame(run, snap, span, frames_counter):
    """The program span ``span``'s ms a frame outside the traced clips:
    frames from the counter ``frames_counter`` less the traced frames."""
    return ms_per(untraced(snap, span),
                  counter(snap, frames_counter) - traced_frames(run))


def clock_offset(run):
    """Trace seconds minus host seconds: the median, over the traced clips,
    of the difference of the ``bench.clip`` span's start on the two
    clocks; None without a trace."""
    if run.trace is None:
        return None
    traced = sorted(s for n, s, _ in run.trace.spans if n == CLIP_SPAN)
    host = [s for n, s, _ in run.spans if n == CLIP_SPAN]
    pairs = list(zip(traced, host))
    if not pairs:
        return None
    return statistics.median(t - h for t, h in pairs)


def kept_on_trace(run, snap, names):
    """The kept program spans named in ``names`` as (start, end) seconds on
    the trace's clock."""
    offset = clock_offset(run)
    if snap is None or offset is None:
        return []
    return [(s.start_ns * 1e-9 + offset, s.end_ns * 1e-9 + offset)
            for s in snap["kept"] if s.name in names]


def overlap(a, b) -> float:
    """Length of the intersection of two sets of (start, end) intervals."""
    a, b = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_percent_inside(run, snap, names):
    """The share of the traced window, in percent, in which the device is
    idle and the host is inside one of the program spans ``names``; None
    when no such span was kept in the window."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    w0, w1 = tr.window
    spans = [(max(s, w0), min(e, w1))
             for s, e in kept_on_trace(run, snap, names)]
    spans = [(s, e) for s, e in spans if e > s]
    if not spans:
        return None
    busy = merged(tr.intervals())
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    return 100.0 * overlap(idle, spans) / tr.window_s
