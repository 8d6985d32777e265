"""The scan kernels' CUDA source, run on the CPU, against the plain twins.

``csrc/scan.cu`` is compiled by the host C++ compiler against a small
emulation of the CUDA runtime it uses (:data:`EMULATED_RUNTIME`): each
thread block runs as ``blockDim`` OS threads, ``__syncthreads`` is a
barrier and ``__syncthreads_or`` a barrier with an OR over the block,
``__shared__`` variables are statics (one per kernel instance), the shared
atomics are ``std::atomic_ref`` operations, and a ``<<<grid, block>>>``
launch runs the blocks one after another. The module's own wrappers then
launch these kernels on CPU tensors (parameter struct, buffer layouts and
launch counts as on the card), and every output must equal the twin's
exactly: records on the bands a pass renders, attributes, packed pixels and
raster z. Built with
``-ffp-contract=off`` and without FMA instructions, the host compiler
contracts nothing, as nvcc with ``--fmad=false`` does not; ``fmaf`` is the C
library's correctly rounded one.

The kernel paths here: the default path's (``march_kernel<false, false,
false>`` at hyps 1 and colfix 1), the colfix K = 3 cascade, the
dual-column records of the quality tier's pass 1, the sparse bands of the
patch tier's pass 2, the edge cull in the standard variant
(``--edge-cull`` at d <= 10), big_grid with edge culling at BASELINE
preset 4's knobs, and big_grid's chunked march (a fetch window of five
128-column chunks) with hyps 2, the K = 3 fan, the cull and the wireframe
coverage. The rest, and the tiers' frames, are held against the
twins on the card (``test_torch_gpu``, ``test_torch_tiers_gpu``,
``test_torch_big_grid_gpu``).

Scene: the card-only tests' seeded d7 scene (``test_torch_gpu``), 128x96;
for the chunked march its depth map at density 9 with every fourth grid row
kept (129 x 513), 512x96, the yawed view.
What this cannot show: that nvcc builds the file for ``sm_90a`` and how fast
it runs; the card tests and ``chip_smoke.py`` do.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from depthrenderer_tpu_torch.ops import cuda_build
from depthrenderer_tpu_torch.ops import raster_scan as rs

from test_torch_gpu import H, N, W, scene_mesh, scene_mvps
from test_torch_tiers_gpu import check_pass

torch.set_num_threads(1)

EMULATED_RUNTIME = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
// Blocks run one after another, so a static per kernel instance serves as
// the block's shared memory.
#define __shared__ static
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3v { unsigned x, y, z; };
inline thread_local uint3v threadIdx, blockIdx;
inline thread_local dim3 blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
// A streaming store is a plain store here.
template <class T>
inline void __stcs(T* p, T v) { *p = v; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetLastError() { return 0; }
inline float __int_as_float(int i) {
  float f;
  __builtin_memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(unsigned u) {
  float f;
  __builtin_memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  __builtin_memcpy(&u, &f, 4);
  return u;
}
inline unsigned long long atomicMin(unsigned long long* a,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> r(*a);
  unsigned long long old = r.load();
  while (v < old && !r.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline unsigned atomicOr(unsigned* a, unsigned v) {
  return std::atomic_ref<unsigned>(*a).fetch_or(v);
}
// One block's barrier. Call n of a thread ORs into slot n % 3 and reads it
// after the barrier; thread (0, 0) then clears slot (n + 2) % 3, whose
// readers (call n - 1) all passed this barrier and whose next writers
// (call n + 2) wait for the next one.
struct BlockSync {
  std::barrier<> bar;
  std::atomic<int> acc[3];
  explicit BlockSync(int n) : bar(n) { for (auto& a : acc) a = 0; }
};
inline BlockSync* g_block = nullptr;
inline thread_local int t_calls = 0;
inline void __syncthreads() { g_block->bar.arrive_and_wait(); }
inline bool __syncthreads_or(bool b) {
  const int n = t_calls++;
  if (b) g_block->acc[n % 3].store(1);
  g_block->bar.arrive_and_wait();
  const bool r = g_block->acc[n % 3].load() != 0;
  if (threadIdx.x == 0 && threadIdx.y == 0) g_block->acc[(n + 2) % 3] = 0;
  return r;
}
template <class F>
void emulated_launch(dim3 grid, dim3 block, F body) {
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        BlockSync sync(block.x * block.y);
        g_block = &sync;
        std::vector<std::thread> threads;
        for (unsigned ty = 0; ty < block.y; ++ty)
          for (unsigned tx = 0; tx < block.x; ++tx)
            threads.emplace_back([&, bx, by, bz, tx, ty] {
              blockIdx = {bx, by, bz};
              threadIdx = {tx, ty, 0};
              blockDim = block;
              t_calls = 0;
              body();
            });
        for (auto& t : threads) t.join();
      }
}
"""


def emulated_source(src: str, launches: int = 3) -> str:
    """A CUDA source (scan.cu unless told otherwise) with the runtime
    header swapped for the emulation and each ``kernel<<<grid, block,
    smem, stream>>>(args);`` turned into ``emulated_launch(grid, block,
    [&] { kernel(args); });`` (the emulation's shared memory is its own)."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src, n = re.subn(
        r"(\w+)<<<\s*(.*?),\s*(\w+),\s*\w+,\s*\(cudaStream_t\)stream\s*>>>"
        r"\((.*?)\);\n",
        lambda m: (f"emulated_launch({m.group(2)}, {m.group(3)}, [&] {{ "
                   f"{m.group(1)}({m.group(4)}); }});\n"),
        src, flags=re.S)
    assert n == launches, n
    return src


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    d = tmp_path_factory.mktemp("scan_emu")
    (d / "emu.h").write_text(EMULATED_RUNTIME)
    (d / "scan.cpp").write_text(emulated_source(
        (cuda_build.CSRC / "scan.cu").read_text()))
    cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-I", str(d), "-o", str(d / "libscan.so"),
           str(d / "scan.cpp")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(d / "libscan.so"))


def route_to_emulated(lib, monkeypatch):
    """Route raster_scan's wrappers to the emulated kernels for CPU tensors
    (until the test ends) and set the launch counters to 0."""
    vp, ip = ctypes.c_void_p, ctypes.POINTER(rs._Params)
    for name, n_ptr in (("scan_solve", 5), ("scan_march", 8),
                        ("scan_shade", 5)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [vp] * n_ptr + [ip, vp]
    lib.scan_error_string.restype = ctypes.c_char_p
    lib.scan_error_string.argtypes = [ctypes.c_int]

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(rs, "_lib", lib)
    monkeypatch.setattr(rs, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(cuda_build, "check_cuda", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    rs.reset_launch_counts()


@pytest.fixture
def emulated(emulated_lib, monkeypatch):
    route_to_emulated(emulated_lib, monkeypatch)
    return torch.device("cpu")


def scene_inputs():
    mesh = scene_mesh()
    return (mesh, scene_mvps(), mesh.vertices.reshape(N, N, 3),
            mesh.texture.image)


@pytest.mark.parametrize("over", [
    dict(hyps=1, colfix=1), dict(hyps=1, colfix=3), dict(quality=True),
    dict(hyps=1, colfix=1, edge_cull_threshold=0.25),
    dict(big_grid=True, rmax=48, colfix=1, hyps=1, sr=10, off=4, dmax=5,
         edge_cull_threshold=0.25),
], ids=["default", "colfix3", "quality-pass1-dualcol", "edge-cull",
        "big-grid-edge-cull"])
def test_kernels_equal_twins(emulated, over):
    _, mvps, vgrid, texture = scene_inputs()
    cfg = rs.suggest_scan_config(N, W, H, **over)
    if cfg.row_edge:
        cfg = rs.tier_configs(cfg, N, N, W, H)[0]
    # The single pass marches without the raster-z plane.
    covered = check_pass(emulated, cfg, mvps, vgrid, texture, W, H,
                         raster_z=cfg.dual_col)
    assert min(covered) > 0.3
    assert rs.LAUNCHES == {"solve": 2, "march": 2, "shade": 2}


def test_sparse_bands_equal_twins(emulated):
    mesh, mvps, vgrid, _ = scene_inputs()
    _, cfg2 = rs.tier_configs(
        rs.suggest_scan_config(N, W, H, patch=True, colfix=3), N, N, W, H)
    g2 = rs.ScanGeometry.of(H, W, N, N, cfg2)
    bflag = torch.zeros((2, g2.nbands), dtype=torch.int32)
    bflag[:, 1::2] = 1
    rng = np.random.default_rng(7)
    blkflag = torch.from_numpy(rng.uniform(size=(2, g2.nbands, g2.nblk))
                               < 0.7) & bflag.bool()[..., None]
    covered = check_pass(emulated, cfg2, rs.swap_mvps(mvps),
                         vgrid.transpose(0, 1).contiguous(),
                         mesh.texture.image.transpose(0, 1).contiguous(), H,
                         W, gates=(bflag, blkflag))
    assert min(covered) > 0.1


def test_chunked_big_grid_equals_twins(emulated):
    """big_grid's chunked march (fetch window 640: five chunks), with the
    second hypothesis, the K = 3 fan, the edge cull and the wireframe
    coverage, on one frame of a 129 x 513 grid at 512x96."""
    mesh = scene_mesh(density=9)
    vgrid = mesh.vertices.reshape(513, 513, 3)[::4].contiguous()
    width = 512
    mvps = scene_mvps(width)[1:]
    cfg = rs.suggest_scan_config(513, width, H, big_grid=True, cw=512,
                                 rmax=48, colfix=3, hyps=2, sr=12, off=5,
                                 dmax=None, edge_cull_threshold=0.25)
    g = rs.ScanGeometry.of(width, H, 129, 513, cfg)
    assert g.cl == 640 and min(cfg.cw + 128, g.cl) // 128 == 5
    prep = rs.prep_scan(mvps, vgrid, width, H, cfg)
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*args, g, cfg)
    assert torch.equal(rec, rs.solve_records_plain(*args, g, cfg))
    margs = args + (prep.canch[0], prep.mid[0], rs.minv_rows(mvps)[0], g, cfg)
    wire = rs.march_exact(rec, *margs, wire=True)
    solid = rs.march_exact(rec, *margs)
    assert torch.equal(wire, rs.march_exact_plain(rec, *margs, wire=True))
    assert torch.equal(solid[:3], wire[:3])
    assert 0.05 < float(wire[3].mean()) < float(solid[3].mean())
    assert rs.LAUNCHES == {"solve": 1, "march": 2, "shade": 0}


def test_sixth_plane_march_equals_twin(emulated):
    """The quality tier's wireframe attrs (ScanParams.wire = 2): the march
    writes the raster z and ml / ar after it, coverage left ungated, equal
    to the twin's; planes 0-4 equal the raster-z march's."""
    _, mvps, vgrid, _ = scene_inputs()
    cfg1, _ = rs.tier_configs(rs.suggest_scan_config(N, W, H, quality=True),
                              N, N, W, H)
    g = rs.ScanGeometry.of(W, H, N, N, cfg1)
    prep = rs.prep_scan(mvps[1:], vgrid, W, H, cfg1)
    args = (prep.win[0], prep.w0[0], prep.bounds[0])
    rec = rs.solve_records(*args, g, cfg1)
    margs = args + (prep.canch[0], prep.mid[0], rs.minv_rows(mvps[1:])[0], g,
                    cfg1)
    six = rs.march_exact(rec, *margs, min_lam=True)
    assert torch.equal(six, rs.march_exact_plain(rec, *margs, min_lam=True))
    assert torch.equal(six[:5], rs.march_exact(rec, *margs, raster_z=True))
    cov = six[3] > 0.5
    assert float(cov.float().mean()) > 0.3 and torch.all(six[5][~cov] == 0)
    assert rs.LAUNCHES == {"solve": 1, "march": 2, "shade": 0}


# ---------------------------------------------------------------------------
# solve alone, on windows built to reach each of its cases
# ---------------------------------------------------------------------------

SOLVE_H, SOLVE_NR = 32, 96   # four bands; window rows of the padded grid


def solve_problem(cfg, n_c, seed):
    """A seeded window, band origins and chunk bounds for ``solve_records``
    -> (win, w0, bounds, g).

    sy falls half a pixel a grid row with noise of +-3 pixels, so each
    scanline crosses its column several times (down-crossings of a noisy
    ramp) at rows that differ from scanline to scanline; every 37th column
    stays above the frame and crosses nothing. Chunk bounds are drawn per
    (band, chunk) with the multi bit set at random, the first chunk of band
    0 scanning from row 0 (strip rows above the window), one chunk scanning
    no row, and every band's last chunk scanning to ``ke``'s cap (the strip
    tail at the window's last rows). big_grid packs each chunk's own
    8-row-aligned window origin."""
    rng = np.random.default_rng(seed)
    g = rs.ScanGeometry.of(64, SOLVE_H, SOLVE_NR, n_c, cfg)
    rows = np.arange(g.rpad, dtype=np.float32)[:, None]
    sy = SOLVE_H - 0.5 * rows + rng.uniform(-3, 3, (g.rpad, g.cl))
    sy[:, ::37] = 1e4
    win = np.stack([rng.uniform(0, 64, (g.rpad, g.cl)), sy,
                    rng.uniform(-1, 1, (g.rpad, g.cl))]).astype(np.float32)
    ke_cap = cfg.rmax - (cfg.sr - cfg.off) - 1
    shape = (g.nbands, g.nchunks)
    kb = rng.integers(0, 4, shape)
    ke = rng.integers(ke_cap // 2, ke_cap + 1, shape)
    kb[0, 0] = 0
    ke[:, -1] = ke_cap
    ke[-1, 0] = kb[-1, 0]
    multi = rng.integers(0, 2, shape)
    multi[:, -1] = 1
    # Band b's scanlines cross near grid rows 16 b .. 16 b + 16.
    origin = np.maximum(16 * np.arange(g.nbands) - 8, 0)
    if cfg.big_grid:
        w0c = origin[:, None] + 8 * rng.integers(0, 2, shape)
        bounds = (w0c // 8) | (kb << 10) | (ke << 19) | (multi << 28)
        w0 = np.zeros(g.nbands)
    else:
        bounds = kb | (ke << 12) | (multi << 24)
        w0 = origin // 8
    return (torch.from_numpy(win), torch.tensor(w0, dtype=torch.int32),
            torch.tensor(bounds.reshape(-1), dtype=torch.int32), g)


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", [
    "multi-nbr4", "dual-col-wrap", "big-grid-ke-cap", "sparse-bands"])
def test_solve_equals_twin(emulated, case):
    """The solve kernel's records equal the twin's bit for bit: several
    slots a scanline at nbr 4 (others filling some and taking the empty
    fill), crossing rows that differ across a column's eight scanlines,
    strip rows above the window, dual-column strips with the last-chunk
    wrap, big_grid's chunk windows to ke's cap, and unflagged bands, which
    the kernel must leave unwritten."""
    cfg = {
        "multi-nbr4": rs.ScanConfig(rmax=48, sr=6, off=2, nbr=4, hyps=1),
        "dual-col-wrap": rs.ScanConfig(rmax=48, sr=6, off=2, nbr=2,
                                       hyps=1, dual_col=True),
        "big-grid-ke-cap": rs.ScanConfig(rmax=32, sr=10, off=4, nbr=3,
                                         hyps=1, big_grid=True),
        "sparse-bands": rs.ScanConfig(rmax=48, sr=6, off=2, nbr=4, hyps=1),
    }[case]
    win, w0, bounds, g = solve_problem(cfg, 384 if case == "sparse-bands"
                                       else 256, seed=len(case))
    bflag = None
    if case == "sparse-bands":
        bflag = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
        rec = torch.full((g.nbands, cfg.nbr, cfg.nrec, 8, g.cl),
                         float("nan"))
        rs._launch("scan_solve", [win.data_ptr(), w0.data_ptr(),
                                  bounds.data_ptr(), bflag.data_ptr(),
                                  rec.data_ptr()], rs._params(g, cfg))
        assert rec[bflag == 0].isnan().all()
    else:
        rec = rs.solve_records(win, w0, bounds, g, cfg)
    assert rs.LAUNCHES["solve"] == 1
    want = rs.solve_records_plain(win, w0, bounds, g, cfg, bflag)
    on = slice(None) if bflag is None else bflag.bool()
    assert torch.equal(bits(rec[on]), bits(want[on]))

    # The cases the problem is built to reach are reached.
    basew = want[on][:, :, 2]                           # (B, nbr, 8, CL)
    filled = basew != rs._NOBASE
    assert filled[:, 0].any() and not filled[..., ::37].any()
    both = filled[:, 0, 0] & filled[:, 0, 7]
    assert (basew[:, 0, 0] != basew[:, 0, 7])[both].any()
    if cfg.nbr == 4:
        assert filled[:, 3].any()
        assert (filled[:, 1] & ~filled[:, 3]).any()
    if not cfg.big_grid:
        assert (filled & (basew < cfg.off)).any()
    if cfg.dual_col:
        # The last column's right strips are the last chunk's first column.
        c = g.cl - 1
        assert filled[..., c].any()
        k = basew[:, 0, :, c][filled[:, 0, :, c]].long()
        right = rec[on][:, 0, 3 + 3, :, c][filled[:, 0, :, c]]
        b = torch.nonzero(filled[:, 0, :, c])[:, 0]
        rows = w0.long()[b] * 8 + k - cfg.off
        assert torch.equal(right[rows >= 0],
                           win[0, rows[rows >= 0], g.cl - 128])
    if cfg.big_grid:
        ke_cap = cfg.rmax - (cfg.sr - cfg.off) - 1
        origin = rs.unpack_bounds(bounds, w0, g, cfg)[0]
        local = basew - origin.repeat_interleave(128, dim=1)[:, None, None]
        assert (filled & (local == ke_cap - 1)).any()
