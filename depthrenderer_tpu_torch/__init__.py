"""depthrenderer_tpu_torch — the depth-image novel-view renderer on PyTorch
and CUDA.

A port of ``depthrenderer_tpu`` (JAX and Pallas on a TPU) to one NVIDIA
H100: colour + depth image -> depth-displaced quad-grid mesh -> animated
novel views rendered by the column-crossing scan rasteriser (hand-written
CUDA kernels in ``csrc/scan.cu``) or the tiled rasteriser (``csrc/pair.cu``),
each kernel with a plain PyTorch twin -> PNG and AVI.

It imports ``torch`` and never ``jax`` or the JAX package. Module names follow
the JAX package's, so each counterpart is easy to find.
"""

from . import animation, io, meshgen, transforms, utils  # noqa: F401
from .scene import Camera, Mesh, Texture  # noqa: F401
from .transforms import Axis  # noqa: F401



def __getattr__(name):
    # The renderers load the ops (and with them the kernels' wrappers) on
    # first use, as the JAX package loads its render module.
    if name in ("MeshRenderer", "render_clip"):
        from . import render

        return getattr(render, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"
