"""``meshgen_ms``: the mean, over the window's clips, of the benchmark's
span around ``Mesh.from_texture`` and the displacement (host clock)."""

import numpy as np


def read(run):
    spans = run.span_seconds("bench.meshgen")
    return 1e3 * float(np.mean(spans)) if spans else None
