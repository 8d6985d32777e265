"""What a ``torch.profiler`` trace of part of the window says: the device's
busy intervals, their union, time by device operation, and the idle gaps
labelled by the benchmark's own span the host was in.

Busy time is the union of the intervals of every kernel, copy and memset
on any stream, not their sum, so overlapping streams are not counted twice.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

KERNEL = "kernel"
COPY = "gpu_memcpy"
MEMSET = "gpu_memset"
DEVICE_CATS = (KERNEL, COPY, MEMSET)
SPAN_PREFIX = "bench."
NAME_CHARS = 160   # of a device operation's name in the breakdown


def merged(intervals):
    """(start, end) intervals merged where they overlap, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


@dataclass
class Trace:
    """Device operations and benchmark spans of a traced part of the
    window; times in seconds on the trace's own clock."""

    ops: list = field(default_factory=list)     # (cat, name, start, end)
    spans: list = field(default_factory=list)   # (name, start, end)
    frames: int = 0                             # frames the traced clips rendered
    window: tuple = (0.0, 0.0)                  # the traced clips' span

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _in_window(self, cats, name_has=None):
        """(cat, name, start, end) of the ops in ``cats``, cut to the
        window."""
        w0, w1 = self.window
        for c, n, s, e in self.ops:
            if c in cats and (name_has is None or name_has in n):
                s, e = max(s, w0), min(e, w1)
                if e > s:
                    yield c, n, s, e

    def intervals(self, cats=DEVICE_CATS, name_has=None):
        return [(s, e) for _, _, s, e in self._in_window(cats, name_has)]

    def busy_s(self, cats=DEVICE_CATS) -> float:
        return union_length(self.intervals(cats))

    def op_seconds(self, cats=DEVICE_CATS):
        """-> {name: summed device seconds}."""
        out = {}
        for _, n, s, e in self._in_window(cats):
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def idle_percent(self):
        """The share of the window in which no device operation ran, in
        percent; None when nothing was traced."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def idle_by_span(self):
        """The window's idle gaps, each labelled by the innermost benchmark
        span covering its middle -> {label: summed seconds}."""
        busy = merged(self.intervals())
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [
            self.window[1]]
        out = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            label = (min(inner, key=lambda sp: sp[2] - sp[1])[0]
                     if inner else "outside any span")
            out[label] = out.get(label, 0.0) + (e - s)
        return out

    def breakdown(self, top: int = 10):
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])
        idle = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in idle[:top]]}


def from_profiler(prof, frames: int, window_span: str) -> Trace:
    """Export ``prof``'s Chrome trace to a temporary file, read it and
    delete it. ``window_span`` names the benchmark span whose extent is the
    traced window."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return from_events(events, frames, window_span)


def from_events(events, frames: int, window_span: str) -> Trace:
    tr = Trace(frames=frames)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            tr.ops.append((cat, name, s, e))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            tr.spans.append((name, s, e))
    windows = [(s, e) for n, s, e in tr.spans if n == window_span]
    if windows:
        tr.window = (min(s for s, _ in windows), max(e for _, e in windows))
    return tr
