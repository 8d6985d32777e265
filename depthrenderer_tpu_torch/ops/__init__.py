"""Rasterisation ops: shared math (:mod:`.common`) and the column-crossing
scan (:mod:`.raster_scan`), whose three passes run as CUDA kernels on the
card and as plain PyTorch on the CPU."""
