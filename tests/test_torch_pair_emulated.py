"""The pair kernel's CUDA source, run on the CPU, against the plain twin.

``csrc/pair.cu`` is compiled by the host C++ compiler against the emulated
CUDA runtime of ``test_torch_scan_emulated`` (each thread block runs as
``blockDim`` OS threads, one block after another; ``__syncthreads`` a
barrier), with what this file adds to it: ``float4``, the cp.async shim
(``__pipeline_memcpy_async`` a plain copy, its commit and wait nothing to
do: the copy has landed when it returns), ``cudaFuncSetAttribute`` as a
no-op and one static buffer as the dynamic shared memory. The package's own
wrapper (``tiled.raster_pairs``) then launches the kernel on CPU tensors
(parameter struct, plane tables, window origins and launch count as on the
card), and its tile rows must equal ``raster_pairs_plain`` on the windows
gathered out of the tables, bit for bit (float32 compared as int32 bits).

Cases: both routes' preps (Pallas route at 1 and 2 row anchors, grid
route at 1 and 2) on a two-frame group of the card-only tests' seeded
scene (``test_torch_gpu``, density 5, 64x48, the two yawed views of
``test_torch_tiled_group``), held against each frame's
own one-frame prep (no frame offset) gathered and run through the twin;
and seeded synthetic tables: two frames, one or two windows a tile, a
ragged last chunk (padding slots), empty and partial active ranges, tiles
of 8x128 (4 pixels a thread) and 4x48 (dead pixels in a warp's segment),
large overlapping triangles so that each pixel row crosses several, and
duplicated table columns (exact depth ties, which the first in chunk then
slot order must win).

Built with ``-ffp-contract=off``, the host compiler contracts nothing, as
nvcc with ``--fmad=false`` does not; ``fmaf`` is the C library's correctly
rounded one. What this cannot show: that nvcc builds the file for
``sm_90a``, cp.async's ordering on the card, and how fast it runs; the
card tests and ``chip_smoke.py`` do.
"""

import ctypes
import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch.ops import common as tcommon
from depthrenderer_tpu_torch.ops import cuda_build
from depthrenderer_tpu_torch.ops import raster_grid as trg
from depthrenderer_tpu_torch.ops import raster_pallas as trp
from depthrenderer_tpu_torch.ops import tiled as ttl

from test_torch_scan_emulated import EMULATED_RUNTIME, emulated_source
from test_torch_tiled_group import H, W, inputs

torch.set_num_threads(1)

PAIR_RUNTIME = r"""
#include <string.h>
// pair.cu's one shared array is the extern pair_smem below.
#undef __shared__
#define __shared__
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
// cp.async: the copy lands before the call returns.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// A warp vote: the block's threads run the same loop, so a vote over the
// block gives the same branch to every lane that has a pixel inside.
inline bool __any_sync(unsigned, bool b) { return __syncthreads_or(b); }
float4 pair_smem[2 * 3 * 1024];
"""


def build_emulated(d, source):
    """Compile a pair.cu source under the emulated runtime in directory
    ``d`` -> the bound library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    (d / "emu.h").write_text(EMULATED_RUNTIME + PAIR_RUNTIME)
    (d / "pair.cpp").write_text(emulated_source(
        source.replace("#include <cuda_pipeline.h>\n", ""), launches=1))
    cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-I", str(d), "-o", str(d / "libpair.so"),
           str(d / "pair.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ttl.bind(ctypes.CDLL(str(d / "libpair.so")))


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    return build_emulated(tmp_path_factory.mktemp("pair_emu"),
                          (cuda_build.CSRC / "pair.cu").read_text())


@pytest.fixture
def emulated(emulated_lib, monkeypatch):
    """Route ``tiled.raster_pairs`` to the emulated kernel for CPU tensors
    (until the test ends) and set the launch counter to 0."""

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ttl, "_lib", emulated_lib)
    monkeypatch.setattr(cuda_build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(cuda_build, "check_cuda", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    ttl.reset_launch_counts()


def bits(t):
    return t.contiguous().view(torch.int32)


def twin(cov, attr, origin, rel, px0, py0, jlo, jhi, height, cfg):
    """The plain twin on the windows gathered out of the tables."""
    return ttl.raster_pairs_plain(
        *ttl.gather_tables(cov, attr, origin, rel, px0.shape[0]), px0, py0,
        jlo, jhi, height, cfg)


@pytest.mark.parametrize("anchors", [1, 2])
@pytest.mark.parametrize("route", ["pallas", "grid"])
def test_group_prep_rows_equal_frame_twins(emulated, route, anchors):
    _, mvps, vg, uvg, cfg = inputs(anchors)
    mvps = mvps[1:]   # two yawed views
    prep = trp._prep_stage_batched if route == "pallas" else trg._grid_group
    rows = ttl.raster_pairs(*prep(mvps, vg, uvg, W, H, cfg), H, cfg)
    assert ttl.LAUNCHES == {"pairs": 1}
    want = torch.cat([twin(*prep(mvps[i:i + 1], vg, uvg, W, H, cfg), H, cfg)
                      for i in range(len(mvps))])
    assert rows.shape == want.shape
    assert torch.equal(bits(rows), bits(want))
    passes = anchors if route == "pallas" else 1   # Pallas: a tile a pass
    assert rows[..., 3].reshape(len(mvps), passes, -1).amax(1).mean() > 0.3


def synthetic_tables(seed, frames, wpt, cfg, tc, nch, cells=300):
    """Seeded plane tables and windows -> ``(cov, attr, origin, rel, px0,
    py0, jlo, jhi)``.

    Six tiles a frame, 3 x 2; triangles with corners spread over them and a
    margin, so that most are several tiles wide and a pixel row crosses
    several; z planes within
    [-1.2, 1.2] (some pixels fail the z test); every 7th column repeats the
    one before it (exact ties). Windows start at seeded columns of their
    frame; the last relative row is ragged (padding slots); tile 0 has an
    empty active range, tile 1 starts at chunk 1."""
    rng = np.random.default_rng(seed)
    th, tw = cfg.tile_h, cfg.tile_w
    n = 2 * cells + 1
    cov = np.zeros((frames, 12, n), np.float64)
    attr = rng.uniform(-2, 2, (frames, 12, n))
    for f in range(frames):
        for c in range(n - 1):
            x = rng.uniform(-tw / 4, 3.25 * tw, 3)
            y = rng.uniform(-th / 2, 2.5 * th, 3)
            area2 = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (
                x[2] - x[0])
            if abs(area2) < 1e-3:
                continue
            lam = []
            for a, b in ((1, 2), (2, 0), (0, 1)):   # λ of the corner opposite
                A = -(y[b] - y[a]) / area2
                B = (x[b] - x[a]) / area2
                lam.append((A, B, (y[b] - y[a]) * x[a] / area2
                            - (x[b] - x[a]) * y[a] / area2))
            zc = rng.uniform(-1.2, 1.2, 3)
            zp = [sum(zc[k] * lam[k][j] for k in range(3)) for j in range(3)]
            cov[f, :, c] = np.concatenate([*lam, zp])
        cov[f, :, 7::7] = cov[f, :, 6:-1:7]
        cov[f, :, -1] = [0, 0, -1, 0, 0, 0, 0, 0, 0, 0, 0, 3e38]
    # Relative columns: chunks of consecutive columns, the last ragged.
    k = np.arange(nch * tc)
    rel = np.where(k < nch * tc - tc // 3, k, -1).reshape(nch, tc)
    ntiles = 6
    px0 = np.tile(np.arange(ntiles) % 3 * tw, frames)
    py0 = np.tile(np.arange(ntiles) // 3 * th, frames)
    span = nch * tc
    origin = np.concatenate([
        f * 12 * n + rng.integers(1, n - 1 - span, ntiles * wpt)
        for f in range(frames)])
    jlo = np.tile([0, 1] + [0] * (ntiles - 2), frames)
    jhi = np.tile([0] + [wpt * nch] * (ntiles - 1), frames)
    i32 = torch.int32
    return (torch.tensor(cov, dtype=torch.float32),
            torch.tensor(attr, dtype=torch.float32),
            torch.tensor(origin, dtype=torch.int64),
            torch.tensor(rel, dtype=i32), torch.tensor(px0, dtype=i32),
            torch.tensor(py0, dtype=i32), torch.tensor(jlo, dtype=i32),
            torch.tensor(jhi, dtype=i32))


@pytest.mark.parametrize("wpt", [1, 2])
@pytest.mark.parametrize("tile", [(8, 128), (4, 48)])
def test_synthetic_tables_equal_twin(emulated, tile, wpt):
    cfg = dataclasses.replace(tcommon.RasterConfig(), tile_h=tile[0],
                              tile_w=tile[1])
    planes = synthetic_tables(sum(tile) + wpt, 2, wpt, cfg, tc=48, nch=3)
    height = 2 * tile[0]
    rows = ttl.raster_pairs(*planes, height, cfg)
    assert ttl.LAUNCHES == {"pairs": 1}
    want = twin(*planes, height, cfg)
    assert torch.equal(bits(rows), bits(want))
    # The cases are reached: an empty tile, covered pixels, z ties.
    cov_flag = want[..., 3]
    assert cov_flag[0].sum() == 0 and cov_flag[6].sum() == 0
    assert 0.2 < float(cov_flag.mean()) < 0.95
    assert (want[..., 4][cov_flag > 0] > 0).any()
