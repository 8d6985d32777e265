"""Rendering over several devices: scenes or frames in contiguous blocks,
one block a device (counterpart of ``depthrenderer_tpu/parallel``)."""

from .sharding import (  # noqa: F401
    default_devices,
    device_blocks,
    render_frames_sharded,
    render_scenes_sharded,
)
