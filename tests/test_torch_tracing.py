"""The port's spans and counters (``depthrenderer_tpu_torch.profiling``) on
the CPU: nothing kept without a profiler, the render loop's and the CLI's
spans under one, the writer's backpressure counters, the bound on kept
spans, and the counters under contention."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation as tanim
from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import profiling
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import transforms as tt
from depthrenderer_tpu_torch import video as tvideo
from depthrenderer_tpu_torch import writers as twriters

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.adopt(None)
    profiling.reset()


def _clip(checker_texture, frames):
    mesh = tdr.Mesh.from_texture(tdr.Texture(checker_texture),
                                 depth_map=checker_texture[..., 0],
                                 density=4)
    camera = tdr.Camera((64, 48), fov_y=18.0)
    views = tt.matmul(tt.translation(dz=-10.0)[None],
                      tanim.default_sway(5.0).batch(
                          tanim.frame_times(frames, 60.0)))
    return mesh, camera.projection, views


def test_without_a_profiler_no_span_is_kept_and_the_counters_tick(
        checker_texture, monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    mesh, projection, views = _clip(checker_texture, frames=2)
    trender.render_clip(mesh, projection, views, 64, 48, device="cpu",
                        impl="pallas", frame_batch=1)
    with profiling.span("test.outer"):
        with profiling.span("test.inner") as inner:
            time.sleep(0.002)
    profiling.count("test.things", 3)
    snap = profiling.snapshot()
    assert snap["kept"] == []
    spans = snap["spans"]
    assert spans["render.clip"]["calls"] == 1
    assert spans["render.upload"]["calls"] == 1
    assert spans["render.dispatch"]["calls"] == 2   # two groups of 1
    assert spans["render.deliver"]["calls"] == 2
    assert spans["scene.mesh_build"]["calls"] == 1
    assert spans["scene.mesh_indices"]["calls"] == 1
    assert snap["counters"]["render.frames"] == 2
    assert snap["counters"]["test.things"] == 3
    assert inner.ms >= 2.0
    assert spans["test.outer"]["seconds"] >= spans["test.inner"]["seconds"]


def test_render_clip_under_the_profiler_keeps_its_spans(checker_texture):
    mesh, projection, views = _clip(checker_texture, frames=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trender.render_clip(mesh, projection, views, 64, 48, device="cpu",
                            impl="pallas")
    kept = profiling.snapshot()["kept"]
    clip, = [s for s in kept if s.name == "render.clip"]
    assert clip.request == clip.id and clip.parent is None
    children = [s for s in kept if s is not clip]
    assert {s.name for s in children} == {"render.upload", "render.dispatch",
                                          "render.deliver"}
    for s in children:
        assert (s.parent, s.request) == (clip.id, clip.id)
        assert clip.start_ns <= s.start_ns <= s.end_ns <= clip.end_ns
    names = {e.name for e in prof.events()}
    assert {"render.clip", "render.upload", "render.dispatch",
            "render.deliver"} <= names


def test_the_cli_request_reaches_the_encoder_thread(checker_texture,
                                                    tmp_path):
    args = tcli.build_parser().parse_args(
        ["c.png", "d.png", "--device", "cpu", "-mesh-density", "4",
         "--width", "64", "--height", "48", "--frames", "2", "--impl",
         "pallas", "-output-path", str(tmp_path)])
    with profile(activities=[ProfilerActivity.CPU]):
        tcli.render_scene(checker_texture, checker_texture[..., 0], args)
    snap = profiling.snapshot()
    kept = snap["kept"]
    root, = [s for s in kept if s.name == "cli.render_scene"]
    assert root.request == root.id and root.parent is None
    assert {s.request for s in kept} == {root.id}
    clip, = [s for s in kept if s.name == "render.clip"]
    assert clip.parent == root.id
    encodes = [s for s in kept if s.name == "writer.encode"]
    assert len(encodes) == 2
    assert all(s.thread != root.thread and s.parent == root.id
               for s in encodes)
    drain, = [s for s in kept if s.name == "writer.drain"]
    assert drain.parent == root.id
    assert snap["counters"]["writer.frames"] == 2
    assert snap["spans"]["writer.encode"]["calls"] == 2


def test_a_full_queue_counts_the_callers_waits(tmp_path, monkeypatch):
    write = tvideo.AviFile.write

    def slow_write(self, frame):
        time.sleep(0.01)
        return write(self, frame)

    monkeypatch.setattr(tvideo.AviFile, "write", slow_write)
    writer = twriters.AsyncVideoWriter(tmp_path / "q.avi", size=(8, 8),
                                       codec="DIB ", max_queue=1)
    for k in range(6):
        writer.write(np.full((8, 8, 4), k, np.uint8))
    writer.cleanup()
    snap = profiling.snapshot()
    assert snap["counters"]["writer.frames"] == 6
    assert snap["spans"]["writer.put_wait"]["calls"] > 0
    assert snap["spans"]["writer.encode"]["calls"] == 6
    assert snap["spans"]["writer.drain"]["calls"] == 1
    assert snap["kept"] == []
    assert len(tvideo.read_avi_frames(str(tmp_path / "q.avi"))) == 6


def test_past_the_bound_spans_are_dropped_and_counted():
    profiling.adopt((None, None))   # keep spans without a profiler
    for _ in range(profiling.MAX_KEPT + 1):
        with profiling.span("test.many"):
            pass
    snap = profiling.snapshot()
    assert profiling.MAX_KEPT == 65_536
    assert len(snap["kept"]) == 65_536
    assert snap["counters"][profiling.DROPPED] == 1
    assert snap["spans"]["test.many"]["calls"] == 65_537


def test_counters_and_totals_lose_nothing_across_threads():
    threads, each = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with profiling.span("test.shared"):
                    profiling.count("test.shared")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.snapshot()
    assert snap["counters"]["test.shared"] == threads * each
    assert snap["spans"]["test.shared"]["calls"] == threads * each


def test_span_table_takes_self_time_as_what_no_child_covers():
    ms = 1_000_000
    kept = [profiling.Span("a", 0, 10 * ms, 1, 1, None, 1),
            profiling.Span("b", 2 * ms, 5 * ms, 1, 2, 1, 1),
            profiling.Span("b", 4 * ms, 7 * ms, 2, 3, 1, 1)]
    table = profiling.span_table(kept, frames=2)
    assert table["a"] == {"total_ms_per_frame": 5.0,
                          "self_ms_per_frame": 2.5}
    assert table["b"] == {"total_ms_per_frame": 3.0,
                          "self_ms_per_frame": 3.0}
