"""The whole slice, the JAX package against the port, from a PNG pair to frames.

A synthetic colour/depth PNG pair goes through each package's own chain: io
(load, resize) -> ``Mesh.from_texture`` at density 7 (a 129x129 grid) ->
camera and two frames of the default sway -> the scan rasteriser at 128x96.
The JAX side runs ``render_frames_scan(raw_u32=True)`` in Pallas interpret
mode (its ``render_clip`` picks the tiled XLA path off a TPU), with the MVPs
its ``render_clip`` builds; the port runs ``render_clip(device="cpu")``, which
takes the plain passes.

Both sides render the config ``suggest_scan_config`` picks for this grid with
``pack_xy=False``, the strip coding the port stores (the same config as
test_torch_scan_kernel_hyps2.py). Bar, as there: PSNR >= 60 dB and at most
0.1% of pixels off by more than 1 LSB. The two packages build their MVPs with
their own sin/cos and products, which may differ in the last bit, and XLA's
CPU backend contracts some of the exact tests' multiply-adds that the port
keeps separate: either can move a pixel centre on an edge to the neighbouring
triangle.

Against the config as the JAX package ships it (``pack_xy=True``), see
test_torch_slice_packxy.py.

Then the port's CLI runs on the CPU with the uncompressed AVI codec, and its
frames must decode equal to ``render_clip``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import depthrenderer_tpu as jdr
from depthrenderer_tpu import animation as janim
from depthrenderer_tpu import io as jio
from depthrenderer_tpu import transforms as jt
from depthrenderer_tpu import video as jvideo
from depthrenderer_tpu.ops import raster_scan as jrs
from depthrenderer_tpu.utils import psnr

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation as tanim
from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import convert
from depthrenderer_tpu_torch import io as tio
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import transforms as tt

# One intra-op thread: the suite's worker processes share the cores, and a
# pool of one thread per core in each of them stalls on these small tensors.
torch.set_num_threads(1)

W, H, DENSITY = 128, 96, 7
N = 2**DENSITY + 1
FRAMES = [0, 74]  # sway frames (of a 300-frame loop at 60 fps)


def write_png_pair(directory, h=48, w=64, seed=0):
    """A seeded RGB colour PNG and an 8-bit depth PNG at half size: a smooth
    sinusoid with a raised step and a pit."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    colour = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                       ((xx // 8 + yy // 8) % 2) * 200 + 27], axis=-1)
    colour = np.clip(colour + rng.normal(0, 6, colour.shape), 0, 255)
    dy, dx = np.mgrid[0:h // 2, 0:w // 2]
    depth = 120 + 90 * np.sin(dx / (w / 2) * 6 + 0.3) * np.cos(dy / (h / 2) * 4)
    depth[h // 8:h // 4, w // 8:w // 4] = 245
    depth[(dx - 22) ** 2 + (dy - 14) ** 2 < 9] = 10
    cp, dp = directory / "scene.png", directory / "scene_depth.png"
    Image.fromarray(colour.astype(np.uint8)).save(cp)
    Image.fromarray(np.clip(depth, 0, 255).astype(np.uint8)).save(dp)
    return cp, dp


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    return write_png_pair(tmp_path_factory.mktemp("slice"))


def slice_config(pack_xy=False):
    return dataclasses.replace(jrs.suggest_scan_config(N, W, H),
                               pack_xy=pack_xy)


def jax_slice(cp, dp, pack_xy=False):
    """The JAX package's chain -> (T, H, W, 4) uint8 frames."""
    colour = jio.load_colour(cp)
    depth = jio.resize(jio.load_depth(dp), colour.shape)
    texture = jdr.Texture(colour)
    mesh = jdr.Mesh.from_texture(texture, depth_map=depth, density=DENSITY)
    mesh.vertices[:, 2] *= 4.0
    camera = jdr.Camera(window_size=(colour.shape[1], colour.shape[0]),
                        fov_y=18.0)
    times = np.asarray(janim.frame_times(300, 60.0))[FRAMES]
    views = (np.asarray(jt.translation(dz=-10.0))[None]
             @ np.asarray(janim.default_sway(5.0).batch(times)))
    mvps = jnp.einsum("ij,tjk,kl->til", jnp.asarray(camera.projection),
                      jnp.asarray(views, jnp.float32),
                      jnp.asarray(mesh.transform, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
    with pltpu.force_tpu_interpret_mode():
        raw = jrs.render_frames_scan(
            mvps, mesh.vertices.reshape(N, N, 3),
            mesh.texture_coordinates.reshape(N, N, 2),
            np.asarray(texture.image, np.float32), W, H, slice_config(pack_xy),
            "texture", interpret=True, raw_u32=True)
        raw = np.asarray(raw)
    return jrs.unpack_raw_frames(raw, W, H)


def port_slice(cp, dp, config=None):
    """The port's chain -> (T, H, W, 4) uint8 frames (plain passes)."""
    colour = tio.load_colour(cp)
    depth = tio.resize(tio.load_depth(dp), colour.shape)
    mesh = tdr.Mesh.from_texture(tdr.Texture(colour), depth_map=depth,
                                 density=DENSITY)
    mesh.vertices[:, 2] *= 4.0
    camera = tdr.Camera(window_size=(colour.shape[1], colour.shape[0]),
                        fov_y=18.0)
    times = tanim.frame_times(300, 60.0)[FRAMES]
    views = tt.matmul(tt.translation(dz=-10.0)[None],
                      tanim.default_sway(5.0).batch(times))
    return trender.render_clip(mesh, camera.projection, views, W, H,
                               config=config, device="cpu")


@pytest.fixture(scope="module")
def port_frames(pngs):
    cfg = convert.scan_config_from_dict(dataclasses.asdict(slice_config()))
    return port_slice(*pngs, config=cfg)


def frame_stats(got, want, label):
    """PSNR over all channels and the share of pixels off by > 1 LSB."""
    assert got.shape == want.shape == (len(FRAMES), H, W, 4)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    p, off = psnr(got, want), float((diff > 1).mean())
    print(f"{label}: PSNR {p:.2f} dB, {off:.5%} > 1 LSB, "
          f"{int((diff > 0).sum())} pixels differ")
    return p, off


def test_slice_frames_match_jax(pngs, port_frames):
    got = port_frames
    p, off = frame_stats(got, jax_slice(*pngs), "slice, pack_xy=False")
    assert p >= 60.0 and off <= 0.001
    # The scene is mostly covered and the sway moves it.
    assert (got[..., :3].max(axis=-1) > 0).mean() > 0.5
    assert not np.array_equal(got[0], got[1])
    # The port's default config is the same one (pack_xy has no effect).
    np.testing.assert_array_equal(port_slice(*pngs)[1:], got[1:])


CLI_ARGS = ["-mesh-density", "5", "--width", "128", "--height", "96",
            "--frames", "4", "--codec", "DIB ", "--device", "cpu"]


def test_cli_writes_the_frames_render_clip_renders(pngs, tmp_path):
    cp, dp = pngs
    out = tmp_path / "out"
    assert tcli.main([str(cp), str(dp), "-output-path", str(out),
                      *CLI_ARGS]) == 0
    video = out / f"{cp.name}.avi"
    assert (out / "sample_frame.png").stat().st_size > 0
    decoded = np.stack(jvideo.read_avi_frames(video))

    colour = tio.load_colour(cp)
    depth = tio.resize(tio.load_depth(dp), colour.shape)
    mesh = tdr.Mesh.from_texture(tdr.Texture(colour), depth_map=depth,
                                 density=5)
    mesh.vertices[:, 2] *= 4.0
    camera = tdr.Camera(window_size=(colour.shape[1], colour.shape[0]),
                        fov_y=18.0)
    views = tt.matmul(tt.translation(dz=-10.0)[None],
                      tanim.default_sway(5.0).batch(
                          tanim.frame_times(4, 60.0)))
    frames = trender.render_clip(mesh, camera.projection, views, 128, 96,
                                 device="cpu")
    assert decoded.shape == (4, 96, 128, 3)
    np.testing.assert_array_equal(decoded, frames[..., :3])
    from PIL import Image

    sample = np.asarray(Image.open(out / "sample_frame.png"))
    np.testing.assert_array_equal(sample, frames[3])
