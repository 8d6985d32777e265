"""``setup_s``: process start to the window's start (host clock): imports,
the kernels' builds (nvcc on a checkout's first run), the scene pool and
one warm clip of the cell's shapes."""


def read(run):
    return run.setup_s
