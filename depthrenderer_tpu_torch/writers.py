"""Frame sinks: synchronous and asynchronous PNG and video writers.

Counterpart of ``depthrenderer_tpu/writers.py`` (reference
``DepthRenderer/utils.py:380-520``): PNGs written in the caller's thread or
on a thread pool, and videos written in the caller's thread or by one
encoder thread fed through a bounded queue (frame order matters; the bound
is backpressure). A video path ending in ``.mp4`` streams into a temporary
AVI that :meth:`VideoWriter.cleanup` converts (:func:`.video.convert_to_mp4`:
H.264 with ffmpeg, else a native remux with the JPEG payloads unchanged).
"""

from __future__ import annotations

import os
import queue
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import profiling
from .io import save_image
from .utils import log
from .video import JPEG_QUALITY, AviFile, convert_to_mp4


def _to_host_uint8(frame):
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = np.clip(np.round(frame), 0, 255).astype(np.uint8)
    return frame


class ImageWriter:
    """Synchronous PNG writer (reference ``utils.py:380-406``)."""

    def write(self, frame, path, file_format="PNG"):
        save_image(_to_host_uint8(frame), path, file_format)

    def cleanup(self):
        pass


class AsyncImageWriter(ImageWriter):
    """PNG writer on a thread pool; :meth:`cleanup` waits for every write and
    raises the first error."""

    def __init__(self, num_workers=4):
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._futures = []

    def write(self, frame, path, file_format="PNG"):
        # Copy so callers may reuse the buffer immediately.
        frame = _to_host_uint8(frame).copy()
        self._futures.append(self._pool.submit(save_image, frame, path,
                                               file_format))

    def cleanup(self):
        self._pool.shutdown(wait=True)
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()


class VideoWriter:
    """Synchronous video writer (reference ``utils.py:440-484``): an AVI
    (MJPG or DIB); a ``.mp4`` path streams into ``<name>.tmp.avi``, which
    :meth:`cleanup` converts. If the conversion fails the AVI is kept as
    ``<name>.avi`` (and ``path`` updated) with a warning."""

    def __init__(self, path, size, fps=24, codec="MJPG",
                 quality=JPEG_QUALITY):
        self.path = str(path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._mp4_target = None
        avi_path = self.path
        if self.path.lower().endswith(".mp4"):
            self._mp4_target = self.path
            avi_path = self.path[:-4] + ".tmp.avi"
        self._avi_path = avi_path
        self.writer = AviFile(avi_path, size, fps=fps, codec=codec,
                              quality=quality)

    def write(self, frame):
        self.writer.write(_to_host_uint8(frame))

    def write_yuv420(self, y, cb, cr):
        """Append a frame given as planar YUV 4:2:0
        (:meth:`.video.AviFile.write_yuv420`)."""
        self.writer.write_yuv420(y, cb, cr)

    def write_jpeg(self, payload: bytes):
        """Append a frame already encoded as a JPEG at the writer's quality
        (:meth:`.video.AviFile.write_jpeg`)."""
        self.writer.write_jpeg(payload)

    def cleanup(self):
        self.writer.close()
        if self._mp4_target is None:
            return
        target, self._mp4_target = self._mp4_target, None
        try:
            convert_to_mp4(self._avi_path, target)
        except (OSError, subprocess.CalledProcessError) as e:
            fallback = target[:-4] + ".avi"
            os.replace(self._avi_path, fallback)
            self.path = fallback
            log(f"MP4 conversion failed ({e}): kept the AVI output at "
                f"{fallback} instead of {target}")


class AsyncVideoWriter(VideoWriter):
    """A :class:`VideoWriter` fed by one encoder thread through a bounded
    queue; an encoder error stops the writes and surfaces on the next
    :meth:`write` or on :meth:`cleanup`.

    Spans and counters (:mod:`.profiling`): ``writer.frames`` counts the
    frames handed over; ``writer.encode`` times each frame's encode and
    append on the encoder thread (for a frame handed over already encoded,
    :meth:`write_jpeg`, the append alone); ``writer.put_wait`` times the
    caller blocked on a full queue; ``writer.drain`` times
    :meth:`cleanup`'s wait for the queue to drain. The encoder thread keeps its spans when the writer was made
    while tracing was on."""

    def __init__(self, path, size, fps=24, codec="MJPG",
                 quality=JPEG_QUALITY, max_queue=64):
        super().__init__(path, size, fps=fps, codec=codec, quality=quality)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._error = None
        self._thread = threading.Thread(target=self._run,
                                        args=(profiling.context(),),
                                        daemon=True)
        self._thread.start()

    def _run(self, trace_context):
        profiling.adopt(trace_context)
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._error is not None:
                continue  # drain; the error surfaces in write/cleanup
            try:
                with profiling.span("writer.encode"):
                    if isinstance(item, bytes):
                        self.writer.write_jpeg(item)
                    elif isinstance(item, tuple):
                        self.writer.write_yuv420(*item)
                    else:
                        self.writer.write(item)
            except Exception as e:  # noqa: BLE001 - surfaced on cleanup
                self._error = e

    def _put(self, item):
        """Queue a frame; time the wait only when the queue is full."""
        profiling.count("writer.frames")
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with profiling.span("writer.put_wait"):
                self._queue.put(item)

    def write(self, frame):
        if self._error is not None:
            raise self._error
        self._put(_to_host_uint8(frame).copy())

    def write_yuv420(self, y, cb, cr):
        if self._error is not None:
            raise self._error
        # Copies, so callers may reuse their planes at once.
        self._put(tuple(np.array(p, dtype=np.uint8) for p in (y, cb, cr)))

    def write_jpeg(self, payload: bytes):
        if self._error is not None:
            raise self._error
        self._put(bytes(payload))

    def cleanup(self):
        with profiling.span("writer.drain"):
            self._queue.put(None)
            self._thread.join()
        if self._error is not None:
            self.writer.close()
            raise self._error
        super().cleanup()
