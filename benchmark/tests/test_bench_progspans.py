"""The metrics that read the program's own spans and counters: the host
spans put on the trace's clock, the idle time behind the encoder, the
per-frame and per-call ratios outside the traced clips, and nothing read
where nothing was recorded (as from a program without the recorder)."""

from collections import namedtuple
from types import SimpleNamespace

import pytest

from benchmark import harness, progspans
from benchmark.devtrace import KERNEL, Trace

Kept = namedtuple("Kept", "name start_ns end_ns")
OFFSET = 100.0   # trace seconds minus host seconds
NEW = ("encode_ms_per_frame.clip", "idle_behind_encoder.clip",
       "mesh_indices_ms", "dispatch_ms_per_frame")


def _ns(t):
    return int(round(t * 1e9))


def _run():
    host_clips = [(1.0, 3.0), (3.5, 5.5)]
    trace = Trace(
        ops=[(KERNEL, "k", 1.0 + OFFSET, 1.5 + OFFSET),
             (KERNEL, "k", 3.5 + OFFSET, 4.0 + OFFSET)],
        spans=[("bench.clip", s + OFFSET, e + OFFSET) for s, e in host_clips],
        frames=240, window=(1.0 + OFFSET, 5.5 + OFFSET))
    return SimpleNamespace(trace=trace,
                           spans=[("bench.clip", s, e) for s, e in host_clips])


def _snap(kept=(), spans=None, counters=None):
    return {"spans": spans or {}, "counters": counters or {},
            "launches": {}, "kept": list(kept)}


def _metric(name):
    return harness.plugin(harness.BENCH, "metrics", name)


def test_idle_behind_the_encoder_on_the_trace_clock(monkeypatch):
    kept = [Kept("writer.put_wait", _ns(1.2), _ns(2.0)),    # idle 0.5
            Kept("writer.drain", _ns(2.0), _ns(3.0)),       # idle 1.0
            Kept("writer.put_wait", _ns(3.6), _ns(4.2)),    # idle 0.2
            Kept("render.dispatch", _ns(1.0), _ns(1.2)),    # not a wait
            Kept("writer.drain", _ns(6.0), _ns(7.0))]       # past the window
    monkeypatch.setattr(progspans, "recorder", lambda: _snap(kept))
    run = _run()
    assert progspans.clock_offset(run) == pytest.approx(OFFSET)
    got = _metric("idle_behind_encoder.clip").read(run)
    assert got == pytest.approx(100.0 * 1.7 / 4.5)
    assert got <= run.trace.idle_percent()


def _kept(name, n, seconds):
    return [Kept(name, 0, _ns(seconds))] * n


def test_the_ratios_of_spans_to_counts(monkeypatch):
    # The traced clips (240 frames): 240 encodes of 0.1 s, 30 dispatches
    # of 0.01 s and 2 index lists of 0.1 s, kept and inside the totals.
    kept = (_kept("writer.encode", 240, 0.1)
            + _kept("render.dispatch", 30, 0.01)
            + _kept("scene.mesh_indices", 2, 0.1))
    snap = _snap(
        kept,
        spans={"writer.encode": {"seconds": 30.0, "calls": 340},
               "scene.mesh_indices": {"seconds": 0.4, "calls": 6},
               "scene.mesh_build": {"seconds": 2.0, "calls": 6},
               "render.dispatch": {"seconds": 0.33, "calls": 38}},
        counters={"writer.frames": 340, "render.frames": 360})
    monkeypatch.setattr(progspans, "recorder", lambda: snap)
    run = _run()
    assert _metric("encode_ms_per_frame.clip").read(run) == pytest.approx(60)
    assert _metric("mesh_indices_ms").read(run) == pytest.approx(50)
    assert _metric("dispatch_ms_per_frame").read(run) == pytest.approx(0.25)
    # Untraced, every span and frame counts.
    snap["kept"] = []
    untraced = SimpleNamespace(trace=None, spans=[])
    assert (_metric("encode_ms_per_frame.clip").read(untraced)
            == pytest.approx(1e3 * 30.0 / 340))
    assert (_metric("mesh_indices_ms").read(untraced)
            == pytest.approx(1e3 * 0.4 / 6))
    assert (_metric("dispatch_ms_per_frame").read(untraced)
            == pytest.approx(1e3 * 0.33 / 360))
    # A dropped span leaves the totals unsplittable: nothing is read.
    snap["kept"] = kept
    snap["counters"][progspans.DROPPED] = 1
    for name in ("encode_ms_per_frame.clip", "mesh_indices_ms",
                 "dispatch_ms_per_frame"):
        assert _metric(name).read(run) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("recorded", [None, _snap()],
                         ids=["no_recorder", "nothing_recorded"])
def test_nothing_recorded_reads_none(monkeypatch, name, recorded):
    monkeypatch.setattr(progspans, "recorder", lambda: recorded)
    for run in (_run(), SimpleNamespace(trace=None, spans=[])):
        assert _metric(name).read(run) is None


def test_the_program_recorder_feeds_the_ratios():
    from depthrenderer_tpu_torch import profiling

    profiling.reset()
    try:
        for _ in range(3):
            with profiling.span("render.dispatch"):
                pass
        profiling.count("render.frames", 48)
        total = progspans.span_total(progspans.recorder(), "render.dispatch")
        assert total[1] == 3
        untraced = SimpleNamespace(trace=None, spans=[])
        assert (_metric("dispatch_ms_per_frame").read(untraced)
                == pytest.approx(1e3 * total[0] / 48))
    finally:
        profiling.reset()
