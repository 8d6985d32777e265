// The column-crossing scan rasteriser's three passes as CUDA kernels.
//
// Replaces the TPU kernel depthrenderer_tpu/ops/raster_scan.py::_scan_kernel
// (one Pallas launch per frame group: solve + strip capture, march + exact
// tests, colfix hole fill, bilinear shade) with three launches per frame:
//
//   solve_kernel  <- the kernel's solve phase (solve_chunk, _solve_phase),
//                    with the dual-column capture (dual_col) and big_grid's
//                    per-chunk windows
//   march_kernel  <- march_block, _exact_record, _exact_cells, _cell_fold and
//                    the colfix fan cascade (fix_slot, K = 0..3), with edge
//                    culling and the wireframe state (the coverage test of
//                    the single pass, or the attrs mode's sixth plane, the
//                    winner's least barycentric weight over its area, which
//                    the quality tier merges before its one wire test); a
//                    template instance per (big_grid, edge cull, wireframe),
//                    so the default path carries neither the cull nor the
//                    wireframe state
//   shade_kernel  <- the attrs capture and shade_block, with the raster-z
//                    output of the texture_z mode
//
// big_grid (d11/d12): every (band, 128-column chunk) has its own row window
// at global row w0c (packed in its bounds word), records hold global bracket
// rows, the march sweeps the whole 128-aligned fetch window, and the colfix
// fan reads global rows with each corner's cells held to its own chunk's
// scan rows. A march window of 4 or more 128-column chunks (d11: 5, d12: 8)
// is swept chunk by chunk behind the reference's block gate.
//
// A per-band flag array (``bflag``, may be null) gives the sparse bands of
// the patch tier: every launch skips an unflagged band band-uniformly; its
// pixels shade packed 0 with raster z FAR, and its records are never written
// or read.
//
// Nothing carries from one TPU grid step to the next, so splitting is free;
// records go through device memory between solve and march. Each launch has a
// plain PyTorch twin in ops/raster_scan.py (solve_records_plain,
// march_exact_plain, shade_plain) computing the same float32 operations in the
// same order; this file is compiled with --fmad=false so that nvcc contracts
// nothing on its own, and the one fused multiply-add the reference rounds with
// (the crossing interpolation) is an explicit fmaf here and an exact emulation
// there.
//
// Launch shape: one CUDA block per 8-row band x 128-column chunk (solve,
// 512 threads: four a grid column, two scanlines each) or 8-row band x
// 128-pixel block (march, 256 threads: warp y = scanline y, four pixels a
// lane). The
// TPU kernel gates whole 8x128 blocks on block-wide reductions (slot gate,
// hypothesis-2 gate, colfix gate, fan row bounds); here they are
// __syncthreads_or over the same 8x128 pixels, taken on block-uniform
// control flow.
//
// What bounds it on an H100, and what the design does about it: every pass
// is gathers and divergent per-thread loops, not FLOPs.
//  * solve writes 3 + 3*sr record planes per slot (3 + 6*sr with
//    dual_col): bound by record stores (~209 MB per 1080p/d10 frame at the
//    default sr = 6, 2.41 GB at 4K/d12), far past the 50 MB L2. A thread
//    walks its column's scan rows [kb, ke) once for two of the band's
//    scanlines (each row's sy loaded once, coalesced across the warp,
//    several rows ahead), keeps their crossing rows in shared memory, and
//    then stores in a loop of its own, uniform across the warp: each store
//    instruction writes one plane row of 32 neighbouring columns (a full
//    128-byte line, empty slots' fill included), with streaming stores.
//    The strip values are gathered from the window, which L1 / L2 hold,
//    since neighbouring columns cross at nearby rows. Four threads a
//    column rather than one: each thread's records, each behind its loads,
//    are a quarter as many, so more stores are in flight per SM (at
//    1080p/d10 on an H100, one thread a column for all eight scanlines
//    takes 13 % longer, two 9 %, eight 19 %; capping registers for more
//    blocks a SM spills and loses).
//  * march: the reference sweeps every record column of the march window
//    per pixel (cw columns; big_grid's chunked fetch window: 640 at d11,
//    1024 at d12). Here each scanline's warp reads each column pair once
//    (coalesced), turns it into the span of the block's pixels it brackets
//    and scatters its packed (key, column) into a shared per-pixel minimum
//    (atomicMin): O(columns) per scanline instead of per pixel, with the
//    dense sweep's comparisons, ties and counts (scatter_pairs). The exact
//    tests then gather 2 x 3 x sr strip values per hypothesis, per thread,
//    one pixel at a time; the block's per-pixel state (the winner, the
//    slots' fan columns) lives in shared memory, so a thread holds one
//    pixel's working set and no instance spills.
//  * colfix loops over a block-uniform row range, 2 to 6 fan columns per
//    row (the K = 3 outer fan carries 6 corner columns in registers).
//  * shade is four texel gathers per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFar = 3.0e38f;          // FAR_SENTINEL
constexpr float kHalfFar = 1.5e38f;      // FAR_SENTINEL * 0.5 in float32
constexpr float kNoBase = -1.0e9f;       // empty-slot bracket row
constexpr float kIdNone = 2.0e30f;       // winner id of an uncovered pixel
constexpr float kWireEdge = 0.15f;       // WIREFRAME_EDGE_THRESHOLD

}  // namespace

// Mirror of ops/raster_scan.py::_Params (field order and types must match).
// mode: 0 texture, 1 debug_z, 2 texture_z; dual: records carry the right
// column's corners (dual_col); raster_z: the march writes a fifth attrs
// plane, the raster z (read by the texture_z shade and the attrs merge);
// big: the big_grid variant; wire: 1, the coverage plane keeps the
// wireframe edge bands; 2, coverage is left as it is and a sixth attrs
// plane (after the raster z) holds ml / ar, the winner's least barycentric
// weight (0 where uncovered); cull: cells whose corner model-z spread
// exceeds cull_thr fail.
struct ScanParams {
  int width, height, n_r, n_c, cl, rpad, wl, hpad, nbands, nchunks, nblk;
  int rmax, cw, cwf, sr, off, nbr, hyps, dmax, colfix, ht, wt, mode, dual;
  int raster_z, big, wire, cull;
  float sxw, syw, inv_ncm1, inv_nrm1, cull_thr;
  float m2[4], m3[4];
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int iclamp(int x, int lo, int hi) {
  return imin(imax(x, lo), hi);
}
__device__ __forceinline__ float fclamp(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// A chunk's row window and scan rows from its packed bounds word: the grid
// row of its window row 0 relative to the band's w0 (big_grid: the chunk's
// own window, w0c / 8 in the low 10 bits), its scan rows [kb, ke) relative
// to that window and its multi-crossing bit.
struct ChunkRows {
  int origin, kb, ke, multi;
};

__device__ __forceinline__ ChunkRows chunk_rows(const ScanParams& p, int bnd) {
  if (p.big)
    return {(bnd & 0x3FF) * 8, (bnd >> 10) & 0x1FF, (bnd >> 19) & 0x1FF,
            (bnd >> 28) & 1};
  return {0, bnd & 0xFFF, (bnd >> 12) & 0xFFF, (bnd >> 24) & 1};
}

// ---------------------------------------------------------------------------
// solve: records (nbands, nbr, nrec, 8, cl) for one frame
// ---------------------------------------------------------------------------

// One block per (band, 128-column chunk); thread (x, h) takes grid column
// x of the chunk and scanlines h * kSolveLines .. + kSolveLines - 1 of the
// band, and walks the column's scan rows once for both of them.
constexpr int kSolveLines = 2;
constexpr int kSolveThreads = 128 * (8 / kSolveLines);
// Scan rows a thread loads ahead of its crossing tests.
constexpr int kSolveAhead = 8;
// Most crossing slots a record keeps (ScanConfig.nbr).
constexpr int kMaxSlots = 4;

__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(const float* __restrict__ win, const int* __restrict__ w0,
             const int* __restrict__ bounds, const int* __restrict__ bflag,
             float* __restrict__ rec, ScanParams p) {
  // The crossing row of slot s of scanline y in column x (-1: none).
  __shared__ int srow[kMaxSlots][8][128];
  const int chunk = blockIdx.x, band = blockIdx.y;
  if (bflag != nullptr && bflag[band] == 0) return;  // sparse band
  const int x = threadIdx.x, y0 = threadIdx.y * kSolveLines;
  const int c = chunk * 128 + x;
  // The right column of dual-column strips: c + 1, and for the table's last
  // column the last chunk's first (the reference's lane roll within its last
  // chunk; the march masks that column).
  const int cright = c + 1 < p.cl ? c + 1 : p.cl - 128;
  const int pr = p.dual ? 6 : 3;  // record planes per strip row
  const ChunkRows cr = chunk_rows(p, bounds[band * p.nchunks + chunk]);
  const int kb = cr.kb, ke = cr.ke;
  const int nbr_eff = (p.nbr >= 2 && cr.multi) ? p.nbr : 1;
  const size_t cl = p.cl;
  const size_t plane = (size_t)p.rpad * cl;
  const int base = w0[band] * 8 + cr.origin;  // grid row of window row 0
  // This column's window rows: row r of plane v at wv[r * cl].
  const float* wx = win + (size_t)base * cl + c;
  const float* wy = wx + plane;
  const float* wz = wx + 2 * plane;

  // The walk: rows k in [kb, ke) in order, s_hi = sy[k] carried from the
  // row before, s_lo = sy[k + 1] loaded kSolveAhead rows ahead. Scanline y
  // keeps its first nbr_eff rows with s_hi >= qy > s_lo, the per-thread
  // loop of the reference's solve for each y.
  float qy[kSolveLines];
  int cnt[kSolveLines];
#pragma unroll
  for (int i = 0; i < kSolveLines; ++i) {
    qy[i] = ((float)p.height - (float)(band * 8 + y0 + i)) - 0.5f;
    cnt[i] = 0;
  }
  float s_hi = kb < ke ? wy[(size_t)kb * cl] : 0.0f;
  for (int k0 = kb; k0 < ke; k0 += kSolveAhead) {
    float lo[kSolveAhead];
#pragma unroll
    for (int j = 0; j < kSolveAhead; ++j)
      lo[j] = k0 + j < ke ? wy[(size_t)(k0 + j + 1) * cl] : 0.0f;
#pragma unroll
    for (int j = 0; j < kSolveAhead; ++j) {
      if (k0 + j >= ke) break;  // block-uniform
      const float s_lo = lo[j];
#pragma unroll
      for (int i = 0; i < kSolveLines; ++i)
        if (cnt[i] < nbr_eff && s_hi >= qy[i] && s_lo < qy[i])
          srow[cnt[i]++][y0 + i][x] = k0 + j;
      s_hi = s_lo;
    }
    bool full = true;
#pragma unroll
    for (int i = 0; i < kSolveLines; ++i) full = full && cnt[i] >= nbr_eff;
    if (full) break;
  }
#pragma unroll
  for (int i = 0; i < kSolveLines; ++i)
    for (int s = cnt[i]; s < p.nbr; ++s) srow[s][y0 + i][x] = -1;

  // The stores: every (slot, plane, scanline) row of the chunk's 128
  // columns is one store instruction per warp (a full 128-byte line), empty
  // slots writing their fill (sxc = zc = FAR, basew = -1e9, zero strips) in
  // the same instruction; streaming stores, since the march reads each
  // record once. Strip rows k-off .. k-off+sr-1; rows above the window
  // read 0.
  const float kbase = p.big ? (float)cr.origin : 0.0f;  // global rows
  const int nrec = 3 + pr * p.sr;
  const size_t pstride = (size_t)8 * cl;
  const int dr = cright - c;
  float* out = rec + (size_t)band * p.nbr * nrec * pstride + c;
  for (int s = 0; s < p.nbr; ++s) {
    for (int y = y0; y < y0 + kSolveLines; ++y) {
      const int k = srow[s][y][x];
      const bool has = k >= 0;
      float* o = out + ((size_t)s * nrec * 8 + y) * cl;
      float sxc = kFar, zc = kFar, basew = kNoBase;
      if (has) {
        const size_t r0 = (size_t)k * cl, r1 = r0 + cl;
        const float q = ((float)p.height - (float)(band * 8 + y)) - 0.5f;
        const float hi = wy[r0], lo = wy[r1];
        const float frac = (hi - q) / fmaxf(hi - lo, 1e-12f);
        sxc = fmaf(wx[r1] - wx[r0], frac, wx[r0]);
        zc = fmaf(wz[r1] - wz[r0], frac, wz[r0]);
        basew = (float)k + kbase;
      }
      __stcs(o, sxc);
      __stcs(o + pstride, zc);
      __stcs(o + 2 * pstride, basew);
#pragma unroll 2
      for (int sj = 0; sj < p.sr; ++sj) {
        const int r = k - p.off + sj;
        const bool in = has && r >= 0;
        const size_t ri = (size_t)imax(r, 0) * cl;
        float* os = o + (size_t)(3 + pr * sj) * pstride;
        __stcs(os, in ? wx[ri] : 0.0f);
        __stcs(os + pstride, in ? wy[ri] : 0.0f);
        __stcs(os + 2 * pstride, in ? wz[ri] : 0.0f);
        if (p.dual) {
          __stcs(os + 3 * pstride, in ? wx[ri + dr] : 0.0f);
          __stcs(os + 4 * pstride, in ? wy[ri + dr] : 0.0f);
          __stcs(os + 5 * pstride, in ? wz[ri + dr] : 0.0f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// march + exact tests + colfix: attrs (4, hpad, wl) for one frame: u, v,
// model z, coverage; with raster_z also the raster z (5, hpad, wl), and with
// wire == 2 then ml / ar (6, hpad, wl)
// ---------------------------------------------------------------------------

struct Best {
  float zn, ar, id, uw, vw, iw;  // z numerator, doubled area, id, attrs*area
  float ml;  // least barycentric weight * area (wireframe instances only)
};

__device__ __forceinline__ float edge_fn(float xa, float ya, float xb,
                                         float yb, float qx, float qy) {
  return (xb - xa) * (qy - ya) - (yb - ya) * (qx - xa);
}

// max / min that give NaN when either side is NaN (as the reference's
// jnp.maximum / jnp.minimum and the twin's torch.maximum / torch.minimum).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float inv_w_of(const ScanParams& p, float x,
                                          float y, float z) {
  return ((p.m3[0] * (x * p.sxw - 1.0f) + p.m3[1] * (y * p.syw - 1.0f)) +
          p.m3[2] * z) + p.m3[3];
}

// A corner's model z for the edge cull (the reference's zm_of / zm_fx): rows
// 2 and 3 of the inverse MVP at the corner's NDC, with every multiply-add
// fused as XLA's CPU backend fuses the reference's expression, then a divide
// guarded at |1/w| <= 1e-30.
__device__ __forceinline__ float model_z(const ScanParams& p, float x,
                                         float y, float z) {
  const float a = fmaf(x, p.sxw, -1.0f);
  const float c = fmaf(y, p.syw, -1.0f);
  const float iw = fmaf(p.m3[2], z, fmaf(p.m3[0], a, p.m3[1] * c)) + p.m3[3];
  const float num = fmaf(p.m2[2], z, fmaf(p.m2[0], a, p.m2[1] * c)) + p.m2[3];
  return num / (fabsf(iw) > 1e-30f ? iw : 1.0f);
}

// A grid corner's projected position and depth.
struct Corner {
  float x, y, z;
};

// One cell's exact coverage test and division-free winner fold (the JAX
// kernel's _cell_fold): the diagonal's sign picks the triangle, the nearer
// depth wins (cross-multiplied), ties go to the lower triangle id. CULL: the
// picked triangle's corner model-z spread must be at most cull_thr; WIRE:
// the winner's least barycentric weight rides along. Corners 00 / 01 are
// the cell's top row (left / right), 10 / 11 its bottom row. A corner's 1/w
// and model z are computed only where a covered pixel needs them (the same
// float operations as the reference's planes, so the same values).
template <bool CULL, bool WIRE>
__device__ __forceinline__ void cell_fold(
    const ScanParams& p, Best& b, bool cell_ok, float diag_e, float top_e,
    float bottom_e, float left_e, float right_e, const Corner& c00,
    const Corner& c10, const Corner& c01, const Corner& c11, float u0,
    float u1, float v_top, float v_bot, float base_id) {
  const bool d = diag_e >= 0.0f;
  const bool inside = (d && top_e >= 0.0f && left_e >= 0.0f) ||
                      (!d && bottom_e >= 0.0f && right_e >= 0.0f);
  if (!(cell_ok && inside)) return;
  const float w_a = d ? diag_e : bottom_e;
  const float w_b = d ? top_e : right_e;
  const float w_c = d ? left_e : -diag_e;
  const float area = (w_a + w_b) + w_c;
  const Corner& ca = d ? c00 : c01;  // the picked triangle's corners a, c
  const Corner& cc = d ? c01 : c11;  // (and 10)
  bool ok = area > 1e-12f;
  if (CULL) {
    const float zm_a = model_z(p, ca.x, ca.y, ca.z);
    const float zm_b = model_z(p, c10.x, c10.y, c10.z);
    const float zm_c = model_z(p, cc.x, cc.y, cc.z);
    const float spread = nan_max(nan_max(zm_a, zm_b), zm_c) -
                         nan_min(nan_min(zm_a, zm_b), zm_c);
    ok = ok && spread <= p.cull_thr;
  }
  const float znum = (w_a * ca.z + w_b * c10.z) + w_c * cc.z;
  const bool cov = ok && (znum >= -area) && (znum <= area);
  const float tid = base_id + (d ? 0.0f : 1.0f);
  const float c_l = znum * b.ar;
  const float c_r = b.zn * area;
  if (cov && ((c_l < c_r) || ((c_l == c_r) && (tid < b.id)))) {
    const float p_a = w_a * inv_w_of(p, ca.x, ca.y, ca.z);
    const float p_b = w_b * inv_w_of(p, c10.x, c10.y, c10.z);
    const float p_c = w_c * inv_w_of(p, cc.x, cc.y, cc.z);
    const float iw = (p_a + p_b) + p_c;
    b.zn = znum;
    b.ar = area;
    b.id = tid;
    b.uw = (d ? u0 : u1) * iw + p.inv_ncm1 * (d ? p_c : -p_b);
    b.vw = (d ? v_top : v_bot) * iw + p.inv_nrm1 * (d ? -p_b : p_a);
    b.iw = iw;
    if (WIRE) b.ml = fminf(w_a, fminf(w_b, w_c));
  }
}

// The march's launch shape: one block per 8-row band x 128-pixel block (the
// reference's gate unit), 256 threads; warp y is scanline y, and lane l
// holds pixels l, l + 32, l + 64 and l + 96 of it.
constexpr int kMarchThreads = 256;
constexpr int kMarchPix = 4;  // pixels per thread
constexpr unsigned long long kNoHit = ~0ull;  // an empty sweep minimum

// The block's per-pixel march state in shared memory: each thread reads and
// writes its own pixels' entries, but the sweep's minima, which every lane
// of a scanline's warp scatters into.
template <bool WIRE>
struct MarchShared {
  unsigned long long best[8][128];  // sweep minimum: packed (key, column)
  unsigned hit1[8][4];              // pixels hit once so far (hyps 2)
  short skip[8][128];               // the second sweep's excluded column
  short fix[4][8][128];             // per slot: the fan's column j0, or -1
  float b[WIRE ? 7 : 6][8][128];    // the winner (Best, field-major)
};

template <bool WIRE>
__device__ __forceinline__ Best load_best(const MarchShared<WIRE>& sm, int y,
                                          int x) {
  Best b;
  b.zn = sm.b[0][y][x];
  b.ar = sm.b[1][y][x];
  b.id = sm.b[2][y][x];
  b.uw = sm.b[3][y][x];
  b.vw = sm.b[4][y][x];
  b.iw = sm.b[5][y][x];
  b.ml = WIRE ? sm.b[WIRE ? 6 : 0][y][x] : 0.0f;
  return b;
}

template <bool WIRE>
__device__ __forceinline__ void store_best(MarchShared<WIRE>& sm, int y, int x,
                                           const Best& b) {
  sm.b[0][y][x] = b.zn;
  sm.b[1][y][x] = b.ar;
  sm.b[2][y][x] = b.id;
  sm.b[3][y][x] = b.uw;
  sm.b[4][y][x] = b.vw;
  sm.b[5][y][x] = b.iw;
  if (WIRE) sm.b[WIRE ? 6 : 0][y][x] = b.ml;
}

// A sweep key below FAR and its column, packed so that the least value is
// the nearest key's first column: the float's bits mapped to an unsigned
// order (-0 taken as +0, which ``key < best`` cannot tell apart) above the
// column.
__device__ __forceinline__ unsigned long long sweep_key(float key, int col) {
  unsigned u = __float_as_uint(key == 0.0f ? 0.0f : key);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)col;
}

__device__ __forceinline__ float sweep_key_value(unsigned long long v) {
  const unsigned u = (unsigned)(v >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The pixels of a block that a record column pair brackets: the first and
// last x in [0, 127] with lo <= qx0 + x <= hi (qx0 = the block's first
// pixel centre; every qx0 + x is exact, so these are the dense sweep's own
// comparisons qx >= lo && qx <= hi). A candidate from the float difference
// is stepped to the exact edge. False when no pixel centre is bracketed
// (also for NaN bounds: fminf / fmaxf give NaN only when both columns are).
__device__ __forceinline__ bool pair_span(float lo, float hi, float qx0,
                                          int& x0, int& x1) {
  if (!(lo <= qx0 + 127.0f) || !(hi >= qx0)) return false;
  int a = 0;
  if (lo > qx0) {
    a = (int)ceilf(lo - qx0);  // lo - qx0 in (0, 127]
    while (a > 0 && qx0 + (float)(a - 1) >= lo) --a;
    while (qx0 + (float)a < lo) ++a;
  }
  int b = 127;
  if (hi < qx0 + 127.0f) {
    b = (int)floorf(hi - qx0);  // hi - qx0 in [0, 127)
    while (b < 127 && qx0 + (float)(b + 1) <= hi) ++b;
    while (qx0 + (float)b > hi) --b;
  }
  x0 = a;
  x1 = b;
  return a <= b;
}

// The reference's bracket sweep of one scanline as an interval scatter:
// each column pair (base + j, base + j + 1), j = 0 .. n - 1, read once by
// one lane of the scanline's warp, offers its key zc[base + j] at column
// tag0 + j to every pixel it brackets (an empty neighbour, sx = FAR, makes
// the span run to the block's edge); a key below FAR is a candidate (NaN is
// not), and the per-pixel minimum of sweep_key is the dense sweep's nearest
// hit with ties to the first column. SKIP leaves out each pixel's skipped
// column (the second hypothesis). COUNT marks pixels as hit, candidates or
// not; returns whether this thread saw a pixel hit a second time.
template <bool SKIP, bool COUNT, bool WIRE>
__device__ bool scatter_pairs(MarchShared<WIRE>& sm, const float* sxr,
                              const float* zcr, int base, int n, int tag0,
                              float qx0, int y, int lane) {
  bool multi = false;
  for (int j = lane; j < n; j += 32) {
    const float a = sxr[base + j];
    const float an = sxr[base + j + 1];
    int x0, x1;
    if (!pair_span(fminf(a, an), fmaxf(a, an), qx0, x0, x1)) continue;
    const float key = zcr[base + j];
    const bool cand = key < kFar;
    if (!COUNT && !cand) continue;
    const int col = tag0 + j;
    const unsigned long long v = sweep_key(key, col);
    for (int x = x0; x <= x1; ++x) {
      if (cand && (!SKIP || sm.skip[y][x] != col))
        atomicMin(&sm.best[y][x], v);
      if (COUNT) {
        const unsigned bit = 1u << (x & 31);
        if (atomicOr(&sm.hit1[y][x >> 5], bit) & bit) multi = true;
      }
    }
  }
  return multi;
}

// The reference's chunked march, for a march window of 4 or more 128-column
// chunks: per chunk of the window [ws, ws + mw), a block gate (some crossing
// x over the chunk and the next chunk's first 8 columns, at any of the
// block's 8 scanlines, at most the block's last pixel centre, and some real
// one at least its first pixel centre - 64), and the chunk's 128 pair bases
// (the window's last chunk: 127) scattered at window columns ch * 128 + j;
// ALL scatters every chunk (the second hypothesis' dense re-sweep).
// Block-uniform call; returns scatter_pairs' second-hit flag.
template <bool ALL, bool SKIP, bool COUNT, bool WIRE>
__device__ bool scatter_chunks(MarchShared<WIRE>& sm, const float* sxr,
                               const float* zcr, int ws, int mw, float qx0,
                               int y, int lane) {
  const int nch = mw / 128;
  bool multi = false;
  for (int ch = 0; ch < nch; ++ch) {
    const int lo = ws + ch * 128;
    const bool last = ch == nch - 1;
    if (!ALL) {
      bool near = false, real = false;
#pragma unroll
      for (int q = 0; q < kMarchPix; ++q) {
        const float v = sxr[lo + lane + 32 * q];
        near = near || v <= qx0 + 127.0f;
        real = real || (v < kHalfFar && v >= qx0 - 64.0f);
      }
      if (!last && lane < 8) {
        const float w = sxr[lo + 128 + lane];
        near = near || w <= qx0 + 127.0f;
        real = real || (w < kHalfFar && w >= qx0 - 64.0f);
      }
      const bool any_near = __syncthreads_or(near);
      const bool any_real = __syncthreads_or(real);
      if (!(any_near && any_real)) continue;  // block-uniform
    }
    multi = scatter_pairs<SKIP, COUNT>(sm, sxr, zcr, lo, last ? 127 : 128,
                                       ch * 128, qx0, y, lane) || multi;
  }
  return multi;
}

// Exact tests of the record at fetch-window column j1 (the march
// hypothesis' column, clamped to the march window, plus off_f) and its
// right neighbour: with dual_col the right column's corners stored in the
// same record, else the neighbour record realigned by the bracket-row
// delta. ``slot`` points at the slot's planes at the pixel's scanline.
template <bool CULL, bool WIRE>
__device__ void exact_record(const ScanParams& p, Best& b, const float* slot,
                             int j1, int canch_f, float w0f, float qx,
                             float qy) {
  const size_t ps = (size_t)8 * p.cl;  // record plane stride
  const int pr = p.dual ? 6 : 3;       // record planes per strip row
  const int c1 = canch_f * 128 + iclamp(j1, 0, p.cwf - 1);
  const int c2 = canch_f * 128 + iclamp(j1 + 1, 0, p.cwf - 1);
  const float bw1 = slot[2 * ps + c1];
  const float bw2 = p.dual ? bw1 : slot[2 * ps + c2];
  const float d = bw2 - bw1;
  // aligned2[k] = strip2[k - d] for |d| <= dmax, else NaN.
  const bool shift_ok = fabsf(d) <= (float)p.dmax;
  const int di = shift_ok ? (int)d : 0;
  const float nanv = __int_as_float(0x7fc00000);
  const float cg = (float)(canch_f * 128) + (float)j1;
  const float u0 = cg * p.inv_ncm1;
  const float u1 = (cg + 1.0f) * p.inv_ncm1;
  const float rg0 = (w0f + bw1) - (float)p.off;
  const bool col_ok = (bw1 > kNoBase) && (cg <= (float)(p.n_c - 2));

  auto strip1 = [&](int k, float& x, float& y, float& z) {
    const float* s = slot + (size_t)(3 + pr * k) * ps;
    x = s[c1];
    y = s[ps + c1];
    z = s[2 * ps + c1];
  };
  auto strip2 = [&](int k, float& x, float& y, float& z) {
    if (p.dual) {  // the record's own right-column corners
      const float* s = slot + (size_t)(3 + pr * k + 3) * ps;
      x = s[c1];
      y = s[ps + c1];
      z = s[2 * ps + c1];
      return;
    }
    const int src = k - di;
    if (shift_ok && src >= 0 && src < p.sr) {
      const float* s = slot + (size_t)(3 + 3 * src) * ps;
      x = s[c2];
      y = s[ps + c2];
      z = s[2 * ps + c2];
    } else {
      x = y = z = nanv;
    }
  };

  if (!col_ok) return;  // no cell of the record is tested
  Corner c00, c01;
  strip1(0, c00.x, c00.y, c00.z);
  strip2(0, c01.x, c01.y, c01.z);
  float prev_bottom = 0.0f;
  for (int k = 0; k < p.sr - 1; ++k) {
    Corner c10, c11;
    strip1(k + 1, c10.x, c10.y, c10.z);
    strip2(k + 1, c11.x, c11.y, c11.z);
    const float top_e =
        k == 0 ? edge_fn(c01.x, c01.y, c00.x, c00.y, qx, qy) : -prev_bottom;
    const float bottom_e = edge_fn(c10.x, c10.y, c11.x, c11.y, qx, qy);
    prev_bottom = bottom_e;
    const float r_cell = rg0 + (float)k;
    if (r_cell >= 0.0f && r_cell <= (float)(p.n_r - 2)) {
      const float v_top = 1.0f - r_cell * p.inv_nrm1;
      const float v_bot = 1.0f - (r_cell + 1.0f) * p.inv_nrm1;
      const float base_id = (r_cell * (float)(p.n_c - 1) + cg) * 2.0f;
      const float diag_e = edge_fn(c10.x, c10.y, c01.x, c01.y, qx, qy);
      const float left_e = edge_fn(c00.x, c00.y, c10.x, c10.y, qx, qy);
      const float right_e = edge_fn(c11.x, c11.y, c01.x, c01.y, qx, qy);
      cell_fold<CULL, WIRE>(p, b, true, diag_e, top_e, bottom_e, left_e,
                            right_e, c00, c10, c01, c11, u0, u1, v_top,
                            v_bot, base_id);
    }
    c00 = c10;
    c01 = c11;
  }
}

// One pixel's colfix fan for one slot: re-test the block's window rows
// [k_lo, k_hi) over the fan's cells around the slot's top-1 column j0 (>= 0:
// the slot has a real marched bracket). The corner columns are j0 +
// offs[cc]; cells lie between consecutive offsets only (the K >= 2 outer fan
// has a gap where the inner fan's cells were), with both corners in the
// fetch window and the left one at most the grid's second-to-last column.
// A cell's row must lie in the block's row bounds [kb_u, ke_u) and on the
// grid (BIG: global grid rows, also inside the scan rows of the chunks its
// two corners land in), so only this pixel's rows are walked; a row's top
// edge is then the previous row's bottom edge recomputed from the same
// corners (the reference carries it), and at k_lo its reverse.
template <int NF, bool BIG, bool CULL, bool WIRE>
__device__ void colfix_pixel(const ScanParams& p, Best& b,
                             const float* __restrict__ win,
                             const int* __restrict__ bounds, int band,
                             int canch_f, int wbase, float w0f, int j0,
                             int k_lo, int k_hi, int kb_u, int ke_u, float qx,
                             float qy, const int (&offs)[NF]) {
  const int rows = BIG ? p.rpad : p.rmax;  // rows of the window read
  int k0 = imax(imax(k_lo, kb_u), -wbase);
  int k1 = imin(imin(k_hi, ke_u), p.n_r - 1 - wbase);
  unsigned cells = 0;         // bit f: cell f is tested
  int rows_f[NF];             // BIG: cell f's rows [lo, hi) as lo | hi << 16
  int ulo = k1, uhi = k0;     // BIG: the union of the cells' rows
#pragma unroll
  for (int f = 0; f + 1 < NF; ++f) {
    const int ix = j0 + offs[f];
    if (offs[f + 1] != offs[f] + 1 || ix < 0 || ix + 1 > p.cwf - 1 ||
        (float)(canch_f * 128 + ix) > (float)(p.n_c - 2))
      continue;
    cells |= 1u << f;
    if constexpr (BIG) {
      const ChunkRows ca =
          chunk_rows(p, bounds[band * p.nchunks + canch_f + ix / 128]);
      const ChunkRows cb =
          chunk_rows(p, bounds[band * p.nchunks + canch_f + (ix + 1) / 128]);
      const int lo = imax(ca.ke > ca.kb ? ca.origin + ca.kb : rows,
                          cb.ke > cb.kb ? cb.origin + cb.kb : rows);
      const int hi = imin(ca.ke > ca.kb ? ca.origin + ca.ke : 0,
                          cb.ke > cb.kb ? cb.origin + cb.ke : 0);
      rows_f[f] = lo | hi << 16;
      if (lo < hi) {
        ulo = imin(ulo, lo);
        uhi = imax(uhi, hi);
      }
    }
  }
  if constexpr (BIG) {
    k0 = imax(k0, ulo);
    k1 = imin(k1, uhi);
  }
  if (cells == 0 || k0 >= k1) return;
  const size_t plane = (size_t)p.rpad * p.cl;
  auto corner = [&](int row, int cc) {
    const size_t i = (size_t)(wbase + row) * p.cl + canch_f * 128 +
                     iclamp(j0 + offs[cc], 0, p.cwf - 1);
    return Corner{win[i], win[plane + i], win[2 * plane + i]};
  };
  Corner t[NF];  // the current row's fan corners
#pragma unroll
  for (int cc = 0; cc < NF; ++cc) t[cc] = corner(k0, cc);
  for (int k = k0; k < k1; ++k) {
    // Row k+1 past the band window re-reads the last 8-row block's first
    // row (the reference's clamped block load), past the padded grid the
    // last row; such rows are masked.
    const int kn = k + 1 >= rows ? (BIG ? rows - 1 : rows - 8) : k + 1;
    const float r_cell = w0f + (float)k;
    const float v_top = 1.0f - r_cell * p.inv_nrm1;
    const float v_bot = 1.0f - (r_cell + 1.0f) * p.inv_nrm1;
    Corner pb;          // the previous corner's next-row corner
    float pline = 0.0f;  // and its column edge
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      const Corner bc = corner(kn, cc);
      const float line = edge_fn(t[cc].x, t[cc].y, bc.x, bc.y, qx, qy);
      if (cc > 0) {
        const int f = cc - 1;
        if (((cells >> f) & 1u) &&
            (!BIG || (k >= (rows_f[f] & 0xFFFF) && k < rows_f[f] >> 16))) {
          const float diag_e = edge_fn(pb.x, pb.y, t[cc].x, t[cc].y, qx, qy);
          const float top_e =
              k == k_lo ? edge_fn(t[cc].x, t[cc].y, t[f].x, t[f].y, qx, qy)
                        : -edge_fn(t[f].x, t[f].y, t[cc].x, t[cc].y, qx, qy);
          const float bottom_e = edge_fn(pb.x, pb.y, bc.x, bc.y, qx, qy);
          const float cg = (float)(canch_f * 128 + j0 + offs[f]);
          const float u0 = cg * p.inv_ncm1;
          const float u1 = (cg + 1.0f) * p.inv_ncm1;
          const float base_id = (r_cell * (float)(p.n_c - 1) + cg) * 2.0f;
          cell_fold<CULL, WIRE>(p, b, true, diag_e, top_e, bottom_e, pline,
                                -line, t[f], pb, t[cc], bc, u0, u1, v_top,
                                v_bot, base_id);
        }
        t[f] = pb;
      }
      pb = bc;
      pline = line;
    }
    t[NF - 1] = pb;
  }
}

// One colfix fan call for one slot (block-uniform call). The block's row
// bounds are the union of the scan rows of every chunk a valid fan corner
// of the block lands in; a pixel without a real marched bracket in the slot
// has no valid corner and is left as it is.
template <int NF, bool BIG, bool CULL, bool WIRE>
__device__ void colfix_slot(const ScanParams& p, MarchShared<WIRE>& sm,
                            const float* __restrict__ win,
                            const int* __restrict__ bounds, int band, int s,
                            int canch_f, int wbase, float w0f, float qx0,
                            float qy, int y, int lane,
                            const int (&offs)[NF]) {
  const int rows = BIG ? p.rpad : p.rmax;  // rows of the window read
  unsigned subs = 0;  // the chunks this thread's valid corners land in
#pragma unroll
  for (int q = 0; q < kMarchPix; ++q) {
    const int j0 = sm.fix[s][y][lane + 32 * q];
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      const int ix = j0 + offs[cc];
      if (j0 >= 0 && ix >= 0 && ix <= p.cwf - 1) subs |= 1u << (ix / 128);
    }
  }
  int kb_u = rows, ke_u = 0;
  const int nsub = p.cwf / 128;
  for (int tt = 0; tt < nsub; ++tt) {
    if (__syncthreads_or((subs >> tt) & 1u)) {
      const ChunkRows cr =
          chunk_rows(p, bounds[band * p.nchunks + canch_f + tt]);
      if (cr.ke > cr.kb) {
        kb_u = imin(kb_u, cr.origin + cr.kb);
        ke_u = imax(ke_u, cr.origin + cr.ke);
      }
    }
  }
  const int k_lo = imin(kb_u / 8, rows / 8 - 1) * 8;
  const int k_hi = imin((ke_u + 8) / 8, rows / 8) * 8;
  if (k_lo >= k_hi) return;  // block-uniform
#pragma unroll 1
  for (int q = 0; q < kMarchPix; ++q) {
    const int x = lane + 32 * q;
    const int j0 = sm.fix[s][y][x];
    if (j0 < 0) continue;
    Best b = load_best(sm, y, x);
    colfix_pixel<NF, BIG, CULL, WIRE>(p, b, win, bounds, band, canch_f,
                                      wbase, w0f, j0, k_lo, k_hi, kb_u, ke_u,
                                      qx0 + (float)x, qy, offs);
    store_best(sm, y, x, b);
  }
}

// One fan call over every slot, each gated on the block still holding an
// uncovered pixel with a real marched bracket in that slot.
template <int NF, bool BIG, bool CULL, bool WIRE>
__device__ void colfix_pass(const ScanParams& p, MarchShared<WIRE>& sm,
                            const float* __restrict__ win,
                            const int* __restrict__ bounds, int band,
                            int canch_f, int wbase, float w0f, float qx0,
                            float qy, int y, int lane,
                            const int (&offs)[NF]) {
  for (int s = 0; s < p.nbr; ++s) {
    bool open = false;
#pragma unroll
    for (int q = 0; q < kMarchPix; ++q) {
      const int x = lane + 32 * q;
      open = open || (sm.b[2][y][x] >= 1.0e30f && sm.fix[s][y][x] >= 0);
    }
    if (__syncthreads_or(open))
      colfix_slot<NF, BIG, CULL, WIRE>(p, sm, win, bounds, band, s, canch_f,
                                       wbase, w0f, qx0, qy, y, lane, offs);
  }
}

// The march window's sweep for one slot -> each pixel's window column in
// ``sm.best``, read by sweep_column; returns this thread's second-hit flag
// (COUNT). Block-uniform call, between two barriers of the caller.
template <bool SKIP, bool COUNT, bool WIRE>
__device__ bool sweep_window(MarchShared<WIRE>& sm, const float* sxr,
                             const float* zcr, bool chunked, bool all,
                             int lo, int len, int ws, int mw, float qx0,
                             int y, int lane) {
  if (!chunked)
    return scatter_pairs<SKIP, COUNT>(sm, sxr, zcr, lo, len - 1, 0, qx0, y,
                                      lane);
  return all ? scatter_chunks<true, SKIP, COUNT>(sm, sxr, zcr, ws, mw, qx0,
                                                 y, lane)
             : scatter_chunks<false, SKIP, COUNT>(sm, sxr, zcr, ws, mw, qx0,
                                                  y, lane);
}

// A pixel's swept column (``none`` when no pair offered it a key below FAR:
// the dense sweep's 0, the gated chunked sweep's mw) and its key.
__device__ __forceinline__ int sweep_column(unsigned long long v, int none,
                                            float& key) {
  key = v == kNoHit ? kFar : sweep_key_value(v);
  return v == kNoHit ? none : (int)(unsigned)(v & 0xffffffffu);
}

template <bool BIG, bool CULL, bool WIRE>
__global__ void __launch_bounds__(kMarchThreads, 2)
march_kernel(const float* __restrict__ rec, const float* __restrict__ win,
             const int* __restrict__ w0, const int* __restrict__ bounds,
             const int* __restrict__ canch, const int* __restrict__ mid,
             const int* __restrict__ bflag, float* __restrict__ attrs,
             ScanParams p) {
  __shared__ MarchShared<WIRE> sm;
  const int blk = blockIdx.x, band = blockIdx.y;
  const int y = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t orow = (size_t)(band * 8 + y) * p.wl + blk * 128 + lane;
  const size_t ap = (size_t)p.hpad * p.wl;
  if (bflag != nullptr && bflag[band] == 0) {  // sparse band: uncovered
#pragma unroll
    for (int q = 0; q < kMarchPix; ++q) {
      const size_t o = orow + 32 * q;
      for (int a = 0; a < 4; ++a) attrs[a * ap + o] = 0.0f;
      if (p.raster_z) attrs[4 * ap + o] = kFar;
      if (WIRE && p.wire == 2) attrs[5 * ap + o] = 0.0f;
    }
    return;
  }
  const float qx0 = (float)(blk * 128) + 0.5f;  // pixel x's centre: qx0 + x
  const float qy = ((float)p.height - (float)(band * 8 + y)) - 0.5f;
  const int canch_m = canch[blk] * 8;
  const int canch_f = canch_m / 128;
  // The march window: big_grid sweeps the whole 128-aligned fetch window,
  // the standard variant cw columns from canch_m; off_f maps a march-window
  // column to a fetch-window column.
  const int mw = BIG ? p.cwf : p.cw;
  const int off_f = BIG ? 0 : canch_m - canch_f * 128;
  const int ws = canch_f * 128 + off_f;
  const bool chunked = mw / 128 >= 4;
  const bool narrow_ok = !BIG && p.cw > 128 && !chunked;
  // -1 (wide) everywhere when cw <= 128 or big_grid, unless the patch pass's
  // block gate set -2 (skip).
  const int midv = mid[band * p.nblk + blk];
  const int wbase = w0[band] * 8;
  const float w0f = (float)wbase;
  const int nrec = 3 + (p.dual ? 6 : 3) * p.sr;
  const size_t ps = (size_t)8 * p.cl;
  const bool need2 = p.hyps == 2;

#pragma unroll
  for (int q = 0; q < kMarchPix; ++q)
    store_best(sm, y, lane + 32 * q,
               Best{kFar, 1.0f, kIdNone, 0.0f, 0.0f, 0.0f, 0.0f});

  for (int s = 0; s < p.nbr; ++s) {
    // This slot's record planes at scanline y (plane stride ps).
    const float* slot =
        rec + ((size_t)band * p.nbr + s) * nrec * ps + (size_t)y * p.cl;
    const float* sxr = slot;       // crossing x
    const float* zcr = slot + ps;  // crossing z
#pragma unroll
    for (int q = 0; q < kMarchPix; ++q) sm.fix[s][y][lane + 32 * q] = -1;
    if (midv == -2) continue;  // block-uniform: no candidates, or gated
    // Slot gate: any record in the block's march window (its narrow window
    // when the block marches narrow), over all 8 rows.
    bool mine = false;
    for (int c = lane; c < mw; c += 32) mine = mine || zcr[ws + c] < kHalfFar;
    bool any_rec = __syncthreads_or(mine);
    const int lo_n = canch_m + imax(midv, 0) * 8;
    if (narrow_ok) {
      bool nar = false;
#pragma unroll
      for (int q = 0; q < kMarchPix; ++q)
        nar = nar || zcr[lo_n + lane + 32 * q] < kHalfFar;
      const bool any_nar = __syncthreads_or(nar);
      if (midv >= 0) any_rec = any_nar;
    }
    if (!any_rec) continue;  // block-uniform

    const bool narrow = narrow_ok && midv >= 0;
    const int lo = narrow ? lo_n : ws;
    const int len = narrow ? 128 : mw;
    const int shift = narrow ? midv * 8 : 0;
#pragma unroll
    for (int q = 0; q < kMarchPix; ++q) sm.best[y][lane + 32 * q] = kNoHit;
    if (need2 && lane < 4) sm.hit1[y][lane] = 0u;
    __syncthreads();
    const bool multi =
        need2 ? sweep_window<false, true>(sm, sxr, zcr, chunked, false, lo,
                                          len, ws, mw, qx0, y, lane)
              : sweep_window<false, false>(sm, sxr, zcr, chunked, false, lo,
                                           len, ws, mw, qx0, y, lane);
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < kMarchPix; ++q) {
      const int x = lane + 32 * q;
      float m1;
      const int o1 = sweep_column(sm.best[y][x], chunked ? mw : 0, m1);
      const int j1 = imin(o1 + shift, mw - 1) + off_f;
      sm.fix[s][y][x] = (short)(m1 < kHalfFar ? j1 : -1);
      sm.skip[y][x] = (short)o1;
      Best b = load_best(sm, y, x);
      exact_record<CULL, WIRE>(p, b, slot, j1, canch_f, w0f, qx0 + (float)x,
                               qy);
      store_best(sm, y, x, b);
    }
    if (need2 && __syncthreads_or(multi)) {
      // The second hypothesis: the nearest hit but the window's first one
      // (a chunked march re-sweeps the whole window, ungated, for both).
      float m2;
      if (chunked) {
#pragma unroll
        for (int q = 0; q < kMarchPix; ++q)
          sm.best[y][lane + 32 * q] = kNoHit;
        __syncthreads();
        sweep_window<false, false>(sm, sxr, zcr, true, true, lo, len, ws, mw,
                                   qx0, y, lane);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kMarchPix; ++q) {
          const int x = lane + 32 * q;
          sm.skip[y][x] = (short)sweep_column(sm.best[y][x], 0, m2);
        }
      }
#pragma unroll
      for (int q = 0; q < kMarchPix; ++q) sm.best[y][lane + 32 * q] = kNoHit;
      __syncthreads();
      sweep_window<true, false>(sm, sxr, zcr, chunked, true, lo, len, ws, mw,
                                qx0, y, lane);
      __syncthreads();
#pragma unroll 1
      for (int q = 0; q < kMarchPix; ++q) {
        const int x = lane + 32 * q;
        const int o2 = sweep_column(sm.best[y][x], 0, m2);
        Best b = load_best(sm, y, x);
        exact_record<CULL, WIRE>(p, b, slot, imin(o2 + shift, mw - 1) + off_f,
                                 canch_f, w0f, qx0 + (float)x, qy);
        store_best(sm, y, x, b);
      }
    }
  }

  // The colfix cascade: the inner fan (K = 0: the one cell j0; K >= 1:
  // cells j0-1 .. j0+1), then at K >= 2 the outer cells where holes remain.
  if (p.colfix == 0) {
    const int inner0[2] = {0, 1};
    colfix_pass<2, BIG, CULL, WIRE>(p, sm, win, bounds, band, canch_f, wbase,
                                    w0f, qx0, qy, y, lane, inner0);
  } else if (p.colfix > 0) {
    const int inner[4] = {-1, 0, 1, 2};
    colfix_pass<4, BIG, CULL, WIRE>(p, sm, win, bounds, band, canch_f, wbase,
                                    w0f, qx0, qy, y, lane, inner);
    if (p.colfix == 2) {
      const int outer2[4] = {-2, -1, 2, 3};
      colfix_pass<4, BIG, CULL, WIRE>(p, sm, win, bounds, band, canch_f,
                                      wbase, w0f, qx0, qy, y, lane, outer2);
    } else if (p.colfix == 3) {
      const int outer3[6] = {-3, -2, -1, 2, 3, 4};
      colfix_pass<6, BIG, CULL, WIRE>(p, sm, win, bounds, band, canch_f,
                                      wbase, w0f, qx0, qy, y, lane, outer3);
    }
  }

#pragma unroll 1
  for (int q = 0; q < kMarchPix; ++q) {
    const int x = lane + 32 * q;
    const Best b = load_best(sm, y, x);
    const float qx = qx0 + (float)x;
    const float bz = b.zn / b.ar;
    bool cov = bz < kFar;
    const float den = fabsf(b.iw) > 1e-30f ? b.iw : 1.0f;
    const float u = cov ? b.uw / den : 0.0f;
    const float v = cov ? b.vw / den : 0.0f;
    const float ndcx = qx * p.sxw - 1.0f;
    const float ndcy = qy * p.syw - 1.0f;
    const float num =
        (((p.m2[0] * ndcx + p.m2[1] * ndcy) + p.m2[2] * bz) + p.m2[3]) * b.ar;
    const float zm = cov ? num / den : 0.0f;
    if (WIRE && p.wire == 1) cov = cov && b.ml <= kWireEdge * b.ar;
    const size_t o = orow + 32 * q;
    attrs[o] = u;
    attrs[ap + o] = v;
    attrs[2 * ap + o] = zm;
    attrs[3 * ap + o] = cov ? 1.0f : 0.0f;
    if (p.raster_z) attrs[4 * ap + o] = bz;
    if (WIRE && p.wire == 2) attrs[5 * ap + o] = b.ml / b.ar;
  }
}

// The march instance for a launch's (big_grid, edge cull, wireframe).
using MarchKernel = void (*)(const float*, const float*, const int*,
                             const int*, const int*, const int*, const int*,
                             float*, ScanParams);

template <bool BIG, bool CULL>
MarchKernel march_for_wire(bool wire) {
  return wire ? march_kernel<BIG, CULL, true> : march_kernel<BIG, CULL, false>;
}

MarchKernel march_for(const ScanParams& p) {
  if (p.big)
    return p.cull ? march_for_wire<true, true>(p.wire)
                  : march_for_wire<true, false>(p.wire);
  return p.cull ? march_for_wire<false, true>(p.wire)
                : march_for_wire<false, false>(p.wire);
}

// ---------------------------------------------------------------------------
// shade: packed RGBA (hpad, wl) from attrs and the packed texture; in the
// texture_z mode also the raster z (hpad, wl)
// ---------------------------------------------------------------------------

__global__ void shade_kernel(const float* __restrict__ attrs,
                             const uint32_t* __restrict__ tex,
                             const int* __restrict__ bflag,
                             uint32_t* __restrict__ out,
                             float* __restrict__ outz, ScanParams p) {
  const size_t n = (size_t)p.hpad * p.wl;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (bflag != nullptr && bflag[i / p.wl / 8] == 0) {  // sparse band
    out[i] = 0u;
    outz[i] = kFar;
    return;
  }
  const float u = attrs[i], v = attrs[n + i], zm = attrs[2 * n + i];
  const bool cov = attrs[3 * n + i] > 0.5f;
  const float tx = fclamp(u * (float)p.wt - 0.5f, 0.0f, (float)p.wt - 1.0f);
  const float ty =
      fclamp((1.0f - v) * (float)p.ht - 0.5f, 0.0f, (float)p.ht - 1.0f);
  const float x0f = floorf(tx), y0f = floorf(ty);
  const float fx = tx - x0f, fy = ty - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = imin(x0 + 1, p.wt - 1), y1 = imin(y0 + 1, p.ht - 1);
  const uint32_t c00 = tex[(size_t)y0 * p.wt + x0];
  const uint32_t c01 = tex[(size_t)y0 * p.wt + x1];
  const uint32_t c10 = tex[(size_t)y1 * p.wt + x0];
  const uint32_t c11 = tex[(size_t)y1 * p.wt + x1];
  float ch[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sh = 8 * k;
    const float a00 = (float)((c00 >> sh) & 0xFF);
    const float a01 = (float)((c01 >> sh) & 0xFF);
    const float a10 = (float)((c10 >> sh) & 0xFF);
    const float a11 = (float)((c11 >> sh) & 0xFF);
    const float top = a00 + (a01 - a00) * fx;
    const float bot = a10 + (a11 - a10) * fx;
    ch[k] = top + (bot - top) * fy;
  }
  if (p.mode == 1) {  // debug_z: grey model z, texture alpha
    const float grey = fclamp(zm, 0.0f, 1.0f) * 255.0f;
    ch[0] = ch[1] = ch[2] = grey;
  }
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float val = cov ? ch[k] : (k == 3 ? 255.0f : 0.0f);
    packed |= (uint32_t)fclamp(rintf(val), 0.0f, 255.0f) << (8 * k);
  }
  out[i] = packed;
  if (p.mode == 2) outz[i] = cov ? attrs[4 * n + i] : kFar;  // texture_z
}

// ---------------------------------------------------------------------------
// C entry points (ctypes): each launches on the given stream and returns
// cudaGetLastError(); the caller allocates every buffer. ``bflag`` (one int
// per band) and ``outz`` may be null.
// ---------------------------------------------------------------------------

extern "C" {

const char* scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The march's block: threads, and pixels a thread.
void scan_march_shape(int* threads, int* pixels) {
  *threads = kMarchThreads;
  *pixels = kMarchPix;
}

int scan_solve(const void* win, const void* w0, const void* bounds,
               const void* bflag, void* rec, const ScanParams* p,
               void* stream) {
  if (p->nbr < 1 || p->nbr > kMaxSlots) return (int)cudaErrorInvalidValue;
  dim3 grid(p->nchunks, p->nbands), block(128, 8 / kSolveLines);
  solve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)win, (const int*)w0, (const int*)bounds,
      (const int*)bflag, (float*)rec, *p);
  return (int)cudaGetLastError();
}

int scan_march(const void* rec, const void* win, const void* w0,
               const void* bounds, const void* canch, const void* mid,
               const void* bflag, void* attrs, const ScanParams* p,
               void* stream) {
  dim3 grid(p->nblk, p->nbands), block(kMarchThreads);
  const MarchKernel march = march_for(*p);
  march<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)rec, (const float*)win, (const int*)w0,
      (const int*)bounds, (const int*)canch, (const int*)mid,
      (const int*)bflag, (float*)attrs, *p);
  return (int)cudaGetLastError();
}

int scan_shade(const void* attrs, const void* tex, const void* bflag,
               void* out, void* outz, const ScanParams* p, void* stream) {
  const size_t n = (size_t)p->hpad * p->wl;
  const int threads = 256;
  shade_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                 (cudaStream_t)stream>>>(
      (const float*)attrs, (const uint32_t*)tex, (const int*)bflag,
      (uint32_t*)out, (float*)outz, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
