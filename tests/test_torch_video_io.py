"""The port's YUV 4:2:0 pack, video containers, readers and writers against
the JAX package's, on the CPU.

Bars, with their reasons:

* The YUV pack: XLA's CPU backend contracts ``0.299*r + 0.587*g + 0.114*b``
  (and the chroma sums) into fused multiply-adds, the port's eager PyTorch
  does not, so a byte may round the other way at an exact .5 tie: at most 1
  LSB on at most 0.1 % of the bytes (measured 0.008 % of Y bytes on seeded
  noise, 0.006 % on the synthetic scene). The inverse, host numpy in both
  packages, is equal.
* ``AviFile.write_yuv420``, ``Mp4File.write_sample`` and the remux are
  native or byte copies in both packages: the files are byte-identical.
  ``Mp4File.write`` encodes with the native encoder here and with Pillow in
  the JAX package: each decodes to within the JPEG bar of the JAX package's
  own ``tests/test_writers_video.py`` (>= 35 dB against the source, within
  3 dB of Pillow).
* The readers decode the same files to equal arrays.
"""

import os

import numpy as np
import pytest
import torch

from depthrenderer_tpu import io as jio
from depthrenderer_tpu import video as jvideo
from depthrenderer_tpu import writers as jwriters
from depthrenderer_tpu.native import jpeg_encode_yuv420 as j_jpeg_yuv420

from depthrenderer_tpu_torch import io as tio
from depthrenderer_tpu_torch import native as tnative
from depthrenderer_tpu_torch import video as tvideo
from depthrenderer_tpu_torch import writers as twriters
from depthrenderer_tpu_torch.synthetic import synthetic_scene
from depthrenderer_tpu_torch.utils import psnr

torch.set_num_threads(1)

H, W, N = 48, 64, 5


def clip(n=N, h=H, w=W):
    """Smooth RGBA frames moving frame to frame, (n, h, w, 4) uint8: the
    JAX package's JPEG-bar image (sharp chroma edges bound any baseline
    4:2:0 encoder the same way)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([np.stack([
        128 + 100 * np.sin((xx + 5 * k) / 9.0),
        128 + 100 * np.cos((yy + 3 * k) / 7.0),
        (xx + yy + 7 * k) * 255 // (w + h + 7 * n),
        np.full((h, w), 255.0)], axis=-1).astype(np.uint8)
        for k in range(n)])


def yuv_mismatch(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("frames", ["noise", "scene", "clip"])
def test_yuv_pack_matches_jax(frames):
    if frames == "noise":
        f = np.random.default_rng(1).integers(0, 256, (3, H, W, 4),
                                              dtype=np.uint8)
    elif frames == "scene":
        f = synthetic_scene()[0]
    else:
        f = clip()
    want = np.asarray(jio.rgba_to_yuv420(f))
    got = tio.rgba_to_yuv420(torch.from_numpy(f))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    worst, share = yuv_mismatch(got.numpy(), want)
    print(f"YUV pack ({frames}): max {worst} LSB on {share:.5%} of bytes")
    assert worst <= 1 and share <= 0.001


def test_yuv_inverse_equals_jax():
    packed = np.asarray(jio.rgba_to_yuv420(clip()[0]))
    np.testing.assert_array_equal(tio.yuv420_to_rgb(packed, H, W),
                                  jio.yuv420_to_rgb(packed, H, W))
    y, cb, cr = tio.yuv420_planes(packed, H, W)
    assert y.shape == (H, W) and cb.shape == cr.shape == (H // 2, W // 2)


def test_odd_sizes_raise():
    with pytest.raises(ValueError, match="even"):
        tio.rgba_to_yuv420(torch.zeros((2, 47, 64, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="even"):
        tio.rgba_to_yuv420(torch.zeros((48, 63, 4), dtype=torch.uint8))


def test_native_yuv_encode_equals_jax():
    y, cb, cr = tio.yuv420_planes(
        tio.rgba_to_yuv420(torch.from_numpy(clip()[1])).numpy(), H, W)
    assert tnative.jpeg_encode_yuv420(y, cb, cr, 90) == \
        j_jpeg_yuv420(y, cb, cr, 90)
    with pytest.raises(ValueError):
        tnative.jpeg_encode_yuv420(y, cb[:-1], cr, 90)


def write_yuv_avis(tmp_path, frames):
    packed = np.asarray(jio.rgba_to_yuv420(frames))
    paths = []
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        path = tmp_path / f"yuv_{name}.avi"
        with mod.AviFile(path, (W, H), fps=30) as f:
            for p in packed:
                f.write_yuv420(*tio.yuv420_planes(p, H, W))
        paths.append(path)
    return paths


def test_avi_write_yuv420_byte_identical_to_jax(tmp_path):
    port, jax = write_yuv_avis(tmp_path, clip())
    assert port.read_bytes() == jax.read_bytes()
    with tvideo.AviFile(tmp_path / "x.avi", (W, H)) as f:
        y, cb, cr = tio.yuv420_planes(
            np.zeros(H * W * 3 // 2, np.uint8), H, W)
        with pytest.raises(ValueError, match="planes"):
            f.write_yuv420(y, cb[:, :-1], cr)   # JAX checks only Y
        with pytest.raises(ValueError, match="planes"):
            f.write_yuv420(y, cb, cr[:-1])
    with tvideo.AviFile(tmp_path / "d.avi", (W, H), codec="DIB ") as f:
        with pytest.raises(ValueError, match="MJPG"):
            f.write_yuv420(y, cb, cr)


def test_mp4_write_sample_and_remux_byte_identical_to_jax(tmp_path):
    avi = tmp_path / "src.avi"
    with jvideo.AviFile(avi, (W, H), fps=24) as f:
        for frame in clip():
            f.write(frame)
    payloads = tvideo.read_avi_payloads(avi)
    assert len(payloads) == N
    files = {}
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        with mod.Mp4File(tmp_path / f"s_{name}.mp4", (W, H), fps=24) as m:
            for p in payloads:
                m.write_sample(p)
        files[name] = mod.remux_avi_to_mp4(avi, tmp_path / f"r_{name}.mp4")
    assert (tmp_path / "s_port.mp4").read_bytes() == \
        (tmp_path / "s_jax.mp4").read_bytes()
    assert open(files["port"], "rb").read() == open(files["jax"], "rb").read()
    assert tvideo.read_mp4_samples(files["port"]) == payloads
    assert avi.exists()   # remove_source defaults to False


def test_mp4_write_decodes_within_the_jpeg_bar(tmp_path):
    frames = clip()
    decoded = {}
    for name, mod in (("port", tvideo), ("jax", jvideo)):
        with mod.Mp4File(tmp_path / f"w_{name}.mp4", (W, H), fps=24) as m:
            for f in frames:
                m.write(f)
        decoded[name] = jvideo.read_mp4_frames(tmp_path / f"w_{name}.mp4")
    for k, f in enumerate(frames):
        port = psnr(decoded["port"][k], f[..., :3])
        jax = psnr(decoded["jax"][k], f[..., :3])
        assert port >= 35.0 and port >= jax - 3.0, (k, port, jax)
    with pytest.raises(ValueError):
        tvideo.Mp4File(tmp_path / "bad.mp4", (W, H)).write(frames[0][:-2])


def test_readers_equal_jax(tmp_path):
    frames = clip()
    avi, dib = tmp_path / "m.avi", tmp_path / "d.avi"
    with tvideo.AviFile(avi, (W, H), fps=12) as f:
        for x in frames:
            f.write(x)
    with tvideo.AviFile(dib, (W, H), fps=12, codec="DIB ") as f:
        for x in frames:
            f.write(x)
    mp4 = tvideo.remux_avi_to_mp4(avi)
    assert mp4 == str(avi)[:-4] + ".mp4"
    for path in (avi, dib, mp4):
        assert tvideo.read_video_info(path) == jvideo.read_video_info(path)
        got, want = (tvideo.read_video_frames(path),
                     jvideo.read_video_frames(path))
        assert len(got) == len(want) == N
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert tvideo.read_avi_info(avi) == jvideo.read_avi_info(avi)
    assert tvideo.read_mp4_info(mp4) == jvideo.read_mp4_info(mp4)
    np.testing.assert_array_equal(tvideo.read_avi_frames(dib)[2],
                                  frames[2][..., :3])   # DIB is bit exact
    # The remux of a DIB AVI encodes its frames (each package with its own
    # encoder), the frame count and size carried over.
    dmp4 = tvideo.remux_avi_to_mp4(dib, tmp_path / "d.mp4")
    assert tvideo.read_mp4_info(dmp4)[:3] == (W, H, N)
    with pytest.raises(ValueError):
        tvideo.read_mp4_info(avi)
    with pytest.raises(ValueError):
        tvideo.read_avi_info(mp4)
    assert isinstance(tvideo.open_video_writer(tmp_path / "o.mp4", (W, H)),
                      tvideo.Mp4File)


def test_convert_to_mp4_without_ffmpeg_remuxes(tmp_path, monkeypatch):
    monkeypatch.setattr(tvideo.shutil, "which", lambda name: None)
    assert not tvideo.ffmpeg_available()
    avi = tmp_path / "c.avi"
    with tvideo.AviFile(avi, (W, H), fps=30) as f:
        for x in clip():
            f.write(x)
    payloads = tvideo.read_avi_payloads(avi)
    mp4 = tvideo.convert_to_mp4(avi)
    assert mp4 == str(tmp_path / "c.mp4") and not avi.exists()
    assert tvideo.read_mp4_samples(mp4) == payloads
    w, h, n, fps = tvideo.read_mp4_info(mp4)
    assert (w, h, n) == (W, H, N) and abs(fps - 30) < 0.01


def test_convert_to_mp4_with_ffmpeg(tmp_path):
    if not tvideo.ffmpeg_available():
        pytest.skip("ffmpeg is not on this host")
    avi = tmp_path / "f.avi"
    with tvideo.AviFile(avi, (W, H), fps=30) as f:
        for x in clip():
            f.write(x)
    mp4 = tvideo.convert_to_mp4(avi, remove_source=False)
    assert os.path.getsize(mp4) > 0 and avi.exists()


def test_writers_sync_and_async(tmp_path):
    frames = clip()
    packed = tio.rgba_to_yuv420(torch.from_numpy(frames)).numpy()
    for cls in (twriters.VideoWriter, twriters.AsyncVideoWriter):
        rgb = cls(tmp_path / cls.__name__ / "rgb.avi", (W, H), fps=30)
        yuv = cls(tmp_path / cls.__name__ / "yuv.avi", (W, H), fps=30)
        for f, p in zip(frames, packed):
            rgb.write(f)
            yuv.write_yuv420(*tio.yuv420_planes(p, H, W))
        rgb.cleanup()
        yuv.cleanup()
        assert tvideo.read_avi_payloads(rgb.path) == \
            [tvideo.encode_jpeg(f[..., :3]) for f in frames]
        assert tvideo.read_avi_payloads(yuv.path) == [
            tnative.jpeg_encode_yuv420(*tio.yuv420_planes(p, H, W))
            for p in packed]
    # The async writer's YUV bytes equal the JAX package's.
    jw = jwriters.AsyncVideoWriter(tmp_path / "jax_yuv.avi", (W, H), fps=30)
    for p in packed:
        jw.write_yuv420(*tio.yuv420_planes(p, H, W))
    jw.cleanup()
    assert (tmp_path / "AsyncVideoWriter" / "yuv.avi").read_bytes() == \
        (tmp_path / "jax_yuv.avi").read_bytes()
    # PNGs: synchronous and pooled, the same bytes.
    tw = twriters.ImageWriter()
    aw = twriters.AsyncImageWriter(num_workers=2)
    for k, f in enumerate(frames[:3]):
        tw.write(f, tmp_path / f"s{k}.png")
        aw.write(f, tmp_path / f"a{k}.png")
    tw.cleanup()
    aw.cleanup()
    for k in range(3):
        assert (tmp_path / f"s{k}.png").read_bytes() == \
            (tmp_path / f"a{k}.png").read_bytes()
        np.testing.assert_array_equal(tio.load_image(tmp_path / f"s{k}.png"),
                                      frames[k])


def test_video_writer_mp4_target(tmp_path, monkeypatch):
    monkeypatch.setattr(tvideo.shutil, "which", lambda name: None)
    frames = clip()
    w = twriters.AsyncVideoWriter(tmp_path / "out.mp4", (W, H), fps=24)
    for f in frames:
        w.write(f)
    w.cleanup()
    assert w.path == str(tmp_path / "out.mp4")
    assert not (tmp_path / "out.tmp.avi").exists()
    assert tvideo.read_mp4_samples(w.path) == \
        [tvideo.encode_jpeg(f[..., :3]) for f in frames]


def test_frame_buffer_helpers_equal_jax():
    f = clip()[0]
    a = tio.read_frame_buffer(f.tobytes(), (W, H))
    b = jio.read_frame_buffer(f.tobytes(), (W, H))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tio.process_frame_numpy(torch.from_numpy(f)),
                                  jio.process_frame_numpy(f))
    np.testing.assert_array_equal(np.asarray(tio.process_frame_pillow(f)),
                                  np.asarray(jio.process_frame_pillow(f)))
    assert tio.process_frame_pillow(a) is a
