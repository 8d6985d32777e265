"""Rasterisation ops: shared math (:mod:`.common`), the column-crossing scan
(:mod:`.raster_scan`), the tiled rasteriser (:mod:`.raster_grid`,
:mod:`.raster_pallas` and what both routes share, :mod:`.tiled`), whose
kernels run as CUDA on the card and as plain PyTorch on the CPU
(:mod:`.cuda_build` compiles them and holds the wrappers' dispatch rule),
the streaming rasteriser for any triangle soup (:mod:`.raster_soup`, plain
PyTorch on every device, as the JAX function is plain ``jnp``) and the
float64 oracles with GL's near-plane clip (:mod:`.raster_reference`)."""
