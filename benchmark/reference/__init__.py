"""The plain reference the benchmark holds the port's output against.

Plain PyTorch, independent of the program: it imports nothing of
``depthrenderer_tpu_torch`` (nor JAX or the JAX package) and takes nothing
the program made. From the scene's colour and depth and the configuration's
numbers it builds its own grid mesh, camera and sway (:mod:`.scene`, float64)
and renders chosen pixel rows of a frame with a brute-force rasteriser
(:mod:`.oracle`, a frozen copy of the port's float64 row oracle).
"""
