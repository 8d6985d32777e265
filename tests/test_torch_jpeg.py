"""The card's JPEG encoder on the CPU: its plain twin and its kernels under
the emulated CUDA runtime against the native host encoder, byte for byte;
the AVI built from ready payloads; the sink in ``render_clip`` refused on
the CPU; the CLI's host-encoded AVI on ``--device cpu``.

Sizes end in partial MCUs in both axes (136x72, 72x40: the right and bottom
edges clamp), frames come in both layouts the render paths give the encoder
(the tiled routes' (F, H, W, 4) uint8 and the scan's padded (F, HPAD, WL)
int32), and the frames hold a gradient, noise (0xFF bytes to stuff) and
flat colours. The emulated kernels (``csrc/jpeg.cu`` built with g++ against
``test_torch_scan_emulated.EMULATED_RUNTIME`` and the warp intrinsics
below, each shuffle a block-wide exchange between two barriers) run the
launches as the card does; they cannot show that nvcc builds the file or
how fast it runs (``test_torch_jpeg_gpu``).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import depthrenderer_tpu_torch as tdr
from depthrenderer_tpu_torch import animation as tanim
from depthrenderer_tpu_torch import cli as tcli
from depthrenderer_tpu_torch import native
from depthrenderer_tpu_torch import render as trender
from depthrenderer_tpu_torch import transforms as tt
from depthrenderer_tpu_torch import video as tvideo
from depthrenderer_tpu_torch import writers as twriters
from depthrenderer_tpu_torch.ops import cuda_build
from depthrenderer_tpu_torch.ops import jpeg

from test_torch_scan_emulated import EMULATED_RUNTIME, emulated_source

torch.set_num_threads(1)

SIZES = [(136, 72), (72, 40)]

WARP_RUNTIME = r"""
#define __constant__
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
template <class T> inline T min(T a, T b) { return b < a ? b : a; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (unsigned long long)y << 32 | x;
  unsigned r = 0;
  for (int k = 0; k < 4; ++k)
    r |= (unsigned)(v >> 8 * (s >> 4 * k & 7) & 255) << 8 * k;
  return r;
}
inline int __float2int_rn(float f) { return (int)nearbyintf(f); }
// A shuffle every thread of the block calls: values exchanged through one
// slot a thread between two barriers.
inline long long g_shfl[1024];
template <class T> T __shfl_up_sync(unsigned, T v, int o) {
  const unsigned t = threadIdx.x;
  g_shfl[t] = (long long)v;
  __syncthreads();
  const T r = (t & 31) >= (unsigned)o ? (T)g_shfl[t - o] : v;
  __syncthreads();
  return r;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  const unsigned t = threadIdx.x;
  g_shfl[t] = (long long)v;
  __syncthreads();
  const T r = (T)g_shfl[t ^ o];
  __syncthreads();
  return r;
}
"""


def frames_of(width, height, seed=0):
    """(4, H, W, 4) uint8: a gradient, noise, white and black."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    grad = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx * yy) % 256,
                     np.full_like(xx, 255)], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
    return np.stack([grad, noise, np.full_like(grad, 255),
                     np.zeros_like(grad)])


def as_raw(frames):
    """The frames in the scan's layout: (F, HPAD, WL) int32, R in the low
    byte, the padding filled with other colours."""
    F, H, W, _ = frames.shape
    raw = np.full((F, H + 5, W + 24, 4), 77, np.uint8)
    raw[:, :, W:] = 99
    raw[:, :H, :W] = frames
    return raw.view(np.int32).reshape(F, H + 5, W + 24)


def native_payloads(frames, quality=92):
    return [native.jpeg_encode(f[..., :3], quality) for f in frames]


@pytest.mark.parametrize("layout", ["rgba", "raw"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_twin_equals_the_native_encoder(size, layout):
    w, h = size
    frames = frames_of(w, h)
    got = jpeg.encode_plain(frames if layout == "rgba" else as_raw(frames),
                            w, h)
    want = native_payloads(frames)
    assert got == want
    assert b"\xff\x00" in want[1]           # the noise has stuffed bytes
    assert all(p.startswith(jpeg.header(w, h, 92)) for p in want)


@pytest.mark.parametrize("quality", [10, 50, 100])
def test_twin_follows_the_quality(quality):
    frames = frames_of(40, 24, seed=quality)[:2]
    assert jpeg.encode_plain(frames, 40, 24, quality) == \
        native_payloads(frames, quality)


def test_twin_stages_add_up():
    """Each block's bits are its fields'; the payload holds their sum,
    padded to a byte, plus one 0x00 a 0xFF."""
    w, h = SIZES[0]
    frames = frames_of(w, h)
    t = jpeg.tables(92)
    coef = jpeg.coefficients_plain(frames, t)
    g = jpeg.Geometry(w, h, 92)
    assert coef.shape == (4, g.nblk, 64)
    bits = jpeg._fields(coef, t)[1].sum(-1)     # each block's bits
    assert bits.max() <= 2112                    # Geometry's capacity
    for f, payload in enumerate(native_payloads(frames)):
        data = payload[len(g.hdr):-2]
        assert len(data) - data.count(b"\xff\x00") == -(-bits[f].sum() // 8)
    # The flat frames: one code a block and nothing else.
    assert (coef[2:, :, 1:] == 0).all()
    # Past int32 bit offsets the encoder refuses the size.
    jpeg.Geometry(7680, 4320, 92)
    with pytest.raises(ValueError, match="too large"):
        jpeg.Geometry(16384, 16384, 92)


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    d = tmp_path_factory.mktemp("jpeg_emu")
    (d / "emu.h").write_text(EMULATED_RUNTIME + WARP_RUNTIME)
    (d / "jpeg.cpp").write_text(emulated_source(
        (cuda_build.CSRC / "jpeg.cu").read_text(), launches=6))
    cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-I", str(d), "-o", str(d / "libjpeg.so"),
           str(d / "jpeg.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return jpeg.bind(ctypes.CDLL(str(d / "libjpeg.so")))


@pytest.mark.parametrize("size,layout,chunks", [
    ((136, 72), "rgba", 1), ((72, 40), "raw", 3)],
    ids=["136x72-rgba-1chunk", "72x40-raw-3chunks"])
def test_emulated_kernels_equal_the_native_encoder(emulated_lib, monkeypatch,
                                                   size, layout, chunks):
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(jpeg, "_lib", emulated_lib)
    monkeypatch.setattr(jpeg, "CHUNKS", chunks)
    monkeypatch.setattr(cuda_build, "check_cuda", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    jpeg.reset_launch_counts()
    w, h = size
    frames = frames_of(w, h)
    enc = jpeg.Encoder(5, w, h, 92)
    offsets, out = enc.encode(torch.from_numpy(
        frames if layout == "rgba" else as_raw(frames)))
    o = offsets.tolist()
    data = out.numpy()
    assert [data[o[k]:o[k + 1]].tobytes() for k in range(4)] == \
        native_payloads(frames)
    np.testing.assert_array_equal(
        enc.scratch(None)["coef"][:4].numpy(),
        jpeg.coefficients_plain(frames, jpeg.tables(92)))
    assert set(jpeg.LAUNCHES.values()) == {1}


def test_an_avi_of_payloads_equals_one_of_frames(tmp_path):
    w, h = SIZES[1]
    frames = frames_of(w, h)
    payloads = native_payloads(frames)
    with tvideo.AviFile(tmp_path / "frames.avi", (w, h), fps=30) as f:
        for x in frames:
            f.write(x)
    with tvideo.AviFile(tmp_path / "jpeg.avi", (w, h), fps=30) as f:
        for p in payloads:
            f.write_jpeg(p)
    want = (tmp_path / "frames.avi").read_bytes()
    assert (tmp_path / "jpeg.avi").read_bytes() == want
    for cls in (twriters.VideoWriter, twriters.AsyncVideoWriter):
        writer = cls(tmp_path / cls.__name__ / "out.avi", (w, h), fps=30)
        assert writer.writer.quality == tvideo.JPEG_QUALITY == 92
        for p in payloads:
            writer.write_jpeg(p)
        writer.cleanup()
        assert (tmp_path / cls.__name__ / "out.avi").read_bytes() == want
    with tvideo.AviFile(tmp_path / "dib.avi", (w, h), codec="DIB ") as f:
        with pytest.raises(ValueError, match="MJPG"):
            f.write_jpeg(payloads[0])


def _clip(checker_texture, frames):
    mesh = tdr.Mesh.from_texture(tdr.Texture(checker_texture),
                                 depth_map=checker_texture[..., 0],
                                 density=4)
    camera = tdr.Camera((64, 48), fov_y=18.0)
    views = tt.matmul(tt.translation(dz=-10.0)[None],
                      tanim.default_sway(5.0).batch(
                          tanim.frame_times(frames, 60.0)))
    return mesh, camera.projection, views


def test_render_clip_jpeg_sink_on_the_cpu(checker_texture):
    """The JPEG sink and the encoder are the card's: on the CPU both refuse
    before any work (the CLI keeps the host encoder there)."""
    w, h = SIZES[1]
    mesh, projection, views = _clip(checker_texture, frames=2)
    with pytest.raises(ValueError, match="on the card"):
        trender.render_clip(mesh, projection, views, w, h, device="cpu",
                            impl="pallas", on_jpeg=lambda start, p: None)
    with pytest.raises(ValueError, match="CUDA"):
        jpeg.Encoder(2, w, h).encode(torch.from_numpy(frames_of(w, h)[:2]))


def test_the_cli_on_the_cpu_writes_the_host_encoded_avi(checker_texture,
                                                        tmp_path,
                                                        monkeypatch):
    """``--device cpu`` keeps the host encoder: no JPEG sink, every frame
    through ``AviFile.write``, the AVI equal to one written from the
    frames render_clip delivered."""
    delivered = []
    render_clip = tcli.render_clip

    def spy(*args, **kwargs):
        assert kwargs["on_jpeg"] is None
        on_frames = kwargs["on_frames"]

        def record(start, frames):
            delivered.extend(frames.copy())
            on_frames(start, frames)

        return render_clip(*args, **{**kwargs, "on_frames": record})

    monkeypatch.setattr(tcli, "render_clip", spy)
    w, h = SIZES[1]
    args = tcli.build_parser().parse_args(
        ["c.png", "d.png", "--device", "cpu", "-mesh-density", "4",
         "--width", str(w), "--height", str(h), "--frames", "3", "--impl",
         "pallas", "-output-path", str(tmp_path / "cli")])
    result = tcli.render_scene(checker_texture, checker_texture[..., 0], args)
    assert len(delivered) == 3
    with tvideo.AviFile(tmp_path / "host.avi", (w, h), fps=60.0) as f:
        for x in delivered:
            f.write(x)
    assert open(result["video"], "rb").read() == \
        (tmp_path / "host.avi").read_bytes()
