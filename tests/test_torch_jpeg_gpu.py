"""The card's JPEG encoder (``csrc/jpeg.cu``) against the native host
encoder, byte for byte, on the shapes the render paths give it.

Card-only tests (marker ``gpu``): each skips without a CUDA device. They
import neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_jpeg_gpu.py

Scenes: the package's seeded synthetic scene (:mod:`.synthetic`) at the
benchmark's sizes: a 120-frame 1080p/d10 clip through the scan (the raw
(F, HPAD, WL) int32 layout), a 16-frame 1080p/d10 group through the tiled
Pallas route ((F, H, W, 4) uint8), one 4K/d12 frame with edge culling
(BASELINE preset 4), and the CLI's MJPG AVI at 1080p/d10. The bar is
equality: the kernels run frameops.c's float steps in its order,
uncontracted.
"""

import os

import numpy as np
import pytest
import torch

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation, cli, io, native, transforms
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import video
from depthrenderer_tpu_torch.ops import jpeg
from depthrenderer_tpu_torch.ops import raster_scan as rs
from depthrenderer_tpu_torch.synthetic import synthetic_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def clip_inputs(width, height, density, frames, seed=0):
    colour, depth = synthetic_scene(seed, h=height, w=width)
    mesh = tdr.Mesh.from_texture(tdr.Texture(colour), depth_map=depth,
                                 density=density)
    mesh.vertices[:, 2] *= 4.0
    projection = tdr.Camera((width, height), fov_y=18.0).projection
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway().batch(animation.frame_times(frames, 60.0)))
    return mesh, projection, views


def card_and_host(mesh, projection, views, width, height, named=(), **kw):
    """render_clip twice on the card: -> (RGBA frames, the JPEG sink's
    payloads, the named frames it delivered)."""
    frames = trender.render_clip(mesh, projection, views, width, height,
                                 device="cuda", **kw)
    payloads, rgba = [], {}
    n = trender.render_clip(
        mesh, projection, views, width, height, device="cuda",
        on_jpeg=lambda start, p: payloads.extend(p),
        on_frames=lambda idx, f: rgba.__setitem__(idx, f.copy()),
        rgba_frames=set(named), **kw)
    assert n == len(frames) == len(payloads)
    return frames, payloads, rgba


def test_scan_clip_every_frame_equals_the_host(cuda):
    """120 frames of 1080p/d10 through the scan (raw layout), with the
    sample frame and every 50th read back as RGBA."""
    mesh, projection, views = clip_inputs(1920, 1080, 10, 120)
    jpeg.reset_launch_counts()
    frames, payloads, rgba = card_and_host(mesh, projection, views, 1920,
                                           1080, named=(0, 10, 50, 100))
    assert jpeg.LAUNCHES["dct"] == 8        # 7 groups of 16 and one of 8
    for k, f in enumerate(frames):
        assert payloads[k] == native.jpeg_encode(f[..., :3]), k
    assert sorted(rgba) == [0, 10, 50, 100]
    for k, f in rgba.items():
        np.testing.assert_array_equal(f, frames[k:k + 1])


def test_short_copies_are_completed(cuda, monkeypatch):
    """A group whose JPEG outgrows the bytes copied with its event has the
    rest copied when it is collected."""
    monkeypatch.setattr(trender._CardJpeg, "START_BYTES_PER_PIXEL", 0.001)
    mesh, projection, views = clip_inputs(1920, 1080, 10, 40)
    frames, payloads, _ = card_and_host(mesh, projection, views, 1920, 1080)
    assert payloads == [native.jpeg_encode(f[..., :3]) for f in frames]


def test_encoder_stages_equal_the_twin(cuda):
    """One raw 1080p group straight through the encoder: coefficients equal
    the twin's, payloads the host's, and again from a strided view."""
    mesh, projection, views = clip_inputs(1920, 1080, 10, 16)
    mvps = trender.clip_mvps(projection, views, mesh.transform)
    vgrid = mesh.vertices.reshape(1025, 1025, 3).to(cuda)
    cfg = rs.suggest_scan_config(1025, 1920, 1080)
    raw, _ = rs.render_frames_scan(mvps, vgrid, None,
                                   mesh.texture.image.to(cuda), 1920, 1080,
                                   cfg, "texture")
    enc = jpeg.Encoder(16, 1920, 1080)
    offsets, out = enc.encode(raw)
    torch.cuda.synchronize()
    host = rs.unpack_raw_frames(raw.cpu(), 1920, 1080)
    np.testing.assert_array_equal(
        enc.scratch(cuda)["coef"].cpu().numpy(),
        jpeg.coefficients_plain(host, jpeg.tables(92)))
    o = offsets.tolist()
    data = out[:o[-1]].cpu().numpy()
    for k in range(16):
        assert data[o[k]:o[k + 1]].tobytes() == \
            native.jpeg_encode(host[k][..., :3]), k


def test_tiled_group_equals_the_host(cuda):
    mesh, projection, views = clip_inputs(1920, 1080, 10, 16)
    frames, payloads, _ = card_and_host(mesh, projection, views, 1920, 1080,
                                        impl="pallas")
    assert payloads == [native.jpeg_encode(f[..., :3]) for f in frames]


def test_4k_d12_frame_equals_the_host(cuda):
    mesh, projection, views = clip_inputs(3840, 2160, 12, 1)
    frames, payloads, _ = card_and_host(mesh, projection, views, 3840, 2160,
                                        edge_cull_threshold=0.25)
    assert payloads == [native.jpeg_encode(frames[0][..., :3])]


def test_cli_avi_equals_the_host_encoded_one(cuda, tmp_path):
    """cli.render_scene on the card (MJPG encoded there) writes the AVI the
    host encoder writes from the same frames, and the same PNGs."""
    colour, depth = synthetic_scene(3, h=1080, w=1920)
    args = cli.build_parser().parse_args(
        ["scene.png", "scene_depth.png", "-mesh-density", "10", "--frames",
         "40", "--png-every", "16", "-output-path", str(tmp_path / "cli")])
    jpeg.reset_launch_counts()
    result = cli.render_scene(colour, depth, args)
    assert jpeg.LAUNCHES["dct"] == 3
    # The same clip's frames, through the host encoder.
    texture = tdr.Texture(colour)
    mesh = tdr.Mesh.from_texture(texture, depth_map=depth, density=10)
    mesh.vertices[:, 2] *= 4.0
    camera = tdr.Camera((1920, 1080), fov_y=18.0)
    views = transforms.matmul(
        transforms.translation(dz=-10.0)[None],
        animation.default_sway(5.0).batch(animation.frame_times(40, 60.0)))
    frames = trender.render_clip(mesh, camera.projection, views, 1920, 1080,
                                 device="cuda")
    with video.AviFile(tmp_path / "host.avi", (1920, 1080), fps=60.0) as f:
        for x in frames:
            f.write(x)
    assert open(result["video"], "rb").read() == \
        (tmp_path / "host.avi").read_bytes()
    np.testing.assert_array_equal(io.load_image(result["sample"]),
                                  frames[10])
    for k in (0, 16, 32):
        np.testing.assert_array_equal(io.load_image(os.path.join(
            tmp_path / "cli", f"{k:06d}.png")), frames[k])


def test_encoder_rejects_bad_inputs(cuda):
    enc = jpeg.Encoder(2, 64, 48)
    with pytest.raises(ValueError, match="frames"):
        enc.encode(torch.zeros((2, 48, 64, 3), dtype=torch.uint8,
                               device=cuda))
    with pytest.raises(ValueError, match="group of 3"):
        enc.encode(torch.zeros((3, 48, 64, 4), dtype=torch.uint8,
                               device=cuda))
    with pytest.raises(ValueError, match="do not hold"):
        enc.encode(torch.zeros((2, 40, 64, 4), dtype=torch.uint8,
                               device=cuda))
