"""Rasterisation ops: shared math (:mod:`.common`), the column-crossing scan
(:mod:`.raster_scan`) and the tiled rasteriser (:mod:`.raster_grid`,
:mod:`.raster_pallas` and what both routes share, :mod:`.tiled`), whose
kernels run as CUDA on the card and as plain PyTorch on the CPU
(:mod:`.cuda_build` compiles them and holds the wrappers' dispatch rule)."""
