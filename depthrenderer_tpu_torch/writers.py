"""Frame sinks: asynchronous PNG and AVI writers.

Counterpart of ``depthrenderer_tpu/writers.py`` (reference
``DepthRenderer/utils.py:380-520``): a thread pool writes PNGs, and one
encoder thread fed by a bounded queue writes the AVI in frame order.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .io import save_image
from .video import AviFile


def _to_host_uint8(frame):
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = np.clip(np.round(frame), 0, 255).astype(np.uint8)
    return frame


class AsyncImageWriter:
    """PNG writer on a thread pool; :meth:`cleanup` waits for every write and
    raises the first error."""

    def __init__(self, num_workers=4):
        self._pool = ThreadPoolExecutor(max_workers=num_workers)
        self._futures = []

    def write(self, frame, path):
        # Copy so callers may reuse the buffer immediately.
        frame = _to_host_uint8(frame).copy()
        self._futures.append(self._pool.submit(save_image, frame, path))

    def cleanup(self):
        self._pool.shutdown(wait=True)
        futures, self._futures = self._futures, []
        for f in futures:
            f.result()


class AsyncVideoWriter:
    """AVI writer fed by a single encoder thread through a bounded queue
    (frame order matters; the bound is backpressure)."""

    def __init__(self, path, size, fps=24, codec="MJPG", quality=92,
                 max_queue=64):
        self.path = str(path)
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self.writer = AviFile(self.path, size, fps=fps, codec=codec,
                              quality=quality)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            frame = self._queue.get()
            if frame is None:
                return
            if self._error is not None:
                continue  # drain; the error surfaces in write/cleanup
            try:
                self.writer.write(frame)
            except Exception as e:  # noqa: BLE001 - surfaced on cleanup
                self._error = e

    def write(self, frame):
        if self._error is not None:
            raise self._error
        self._queue.put(_to_host_uint8(frame).copy())

    def cleanup(self):
        self._queue.put(None)
        self._thread.join()
        self.writer.close()
        if self._error is not None:
            raise self._error
