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
//                    culling and the wireframe coverage; a template instance
//                    per (big_grid, edge cull, wireframe), so the default
//                    path carries neither the cull nor the wireframe state
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
// Launch shape: one CUDA block per 8-row band x 128-column chunk (solve) or
// 8-row band x 128-pixel block (march): 1024 threads, thread (x, y) = one grid
// column or pixel. The TPU kernel gates whole 8x128 blocks on block-wide
// reductions (slot gate, hypothesis-2 gate, colfix gate, fan row bounds);
// here they are __syncthreads_or over the same 8x128 threads, taken on
// block-uniform control flow.
//
// What bounds it on an H100, and what the design does about it: every pass
// is gathers and divergent per-thread loops, not FLOPs.
//  * solve walks a column's scan rows [kb, ke) (coalesced across the 128
//    threads of a row) and writes 3 + 3*sr record planes per slot (3 + 6*sr
//    with dual_col): bound by record stores (~200 MB per 1080p/d10 frame at
//    the default sr = 6). Records are written once,
//    at the crossing, straight from the window (no ring buffer).
//  * march sweeps cw record columns per slot (big_grid: the fetch window,
//    640 at d11, 1024 at d12; the 128 threads of a row read the same
//    addresses: broadcasts from L1) and then gathers 2 x 3 x sr strip
//    values per hypothesis: bound by L1/L2 gather latency and by the register
//    cap that 1024-thread blocks impose (64 per thread; the rest spills).
//    Strip rows are read as the cell loop needs them instead of staged.
//  * colfix loops over a block-uniform row range, 2 to 6 fan columns per
//    row (the K = 3 outer fan carries 6 corner columns in registers).
//  * shade is four texel gathers per pixel.
// Staging the band window and records in shared memory (or TMA) is later
// work; this version is the simple, exact one.

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
// big: the big_grid variant; wire: the coverage plane keeps the wireframe
// edge bands; cull: cells whose corner model-z spread exceeds cull_thr fail.
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

__global__ void __launch_bounds__(1024)
solve_kernel(const float* __restrict__ win, const int* __restrict__ w0,
             const int* __restrict__ bounds, const int* __restrict__ bflag,
             float* __restrict__ rec, ScanParams p) {
  const int chunk = blockIdx.x, band = blockIdx.y;
  if (bflag != nullptr && bflag[band] == 0) return;  // sparse band
  const int y = threadIdx.y;
  const int c = chunk * 128 + threadIdx.x;
  // The right column of dual-column strips: c + 1, and for the table's last
  // column the last chunk's first (the reference's lane roll within its last
  // chunk; the march masks that column).
  const int cright = c + 1 < p.cl ? c + 1 : p.cl - 128;
  const int pr = p.dual ? 6 : 3;  // record planes per strip row
  const ChunkRows cr = chunk_rows(p, bounds[band * p.nchunks + chunk]);
  const int kb = cr.kb, ke = cr.ke;
  const int nbr_eff = (p.nbr >= 2 && cr.multi) ? p.nbr : 1;
  const float qy = ((float)p.height - (float)(band * 8 + y)) - 0.5f;
  const size_t plane = (size_t)p.rpad * p.cl;
  const float* wx = win;
  const float* wy = win + plane;
  const float* wz = win + 2 * plane;
  const int base = w0[band] * 8 + cr.origin;  // grid row of window row 0
  // big_grid records hold global bracket rows.
  const float kbase = p.big ? (float)cr.origin : 0.0f;
  const int nrec = 3 + pr * p.sr;
  const size_t pstride = (size_t)8 * p.cl;
  float* out = rec + (size_t)band * p.nbr * nrec * pstride + (size_t)y * p.cl
               + c;

  int cnt = 0;
  for (int k = kb; k < ke && cnt < nbr_eff; ++k) {
    const size_t r0 = (size_t)(base + k) * p.cl + c;
    const size_t r1 = r0 + p.cl;
    const float s_hi = wy[r0], s_lo = wy[r1];
    if (s_hi >= qy && s_lo < qy) {
      const float frac = (s_hi - qy) / fmaxf(s_hi - s_lo, 1e-12f);
      float* o = out + (size_t)cnt * nrec * pstride;
      o[0] = fmaf(wx[r1] - wx[r0], frac, wx[r0]);
      o[pstride] = fmaf(wz[r1] - wz[r0], frac, wz[r0]);
      o[2 * pstride] = (float)k + kbase;
      // Strip rows k-off .. k-off+sr-1; rows above the window read 0.
      for (int sj = 0; sj < p.sr; ++sj) {
        const int r = k - p.off + sj;
        const size_t ri = (size_t)(base + imax(r, 0)) * p.cl;
        float* os = o + (size_t)(3 + pr * sj) * pstride;
        os[0] = r >= 0 ? wx[ri + c] : 0.0f;
        os[pstride] = r >= 0 ? wy[ri + c] : 0.0f;
        os[2 * pstride] = r >= 0 ? wz[ri + c] : 0.0f;
        if (p.dual) {
          os[3 * pstride] = r >= 0 ? wx[ri + cright] : 0.0f;
          os[4 * pstride] = r >= 0 ? wy[ri + cright] : 0.0f;
          os[5 * pstride] = r >= 0 ? wz[ri + cright] : 0.0f;
        }
      }
      ++cnt;
    }
  }
  for (int s = cnt; s < p.nbr; ++s) {
    float* o = out + (size_t)s * nrec * pstride;
    o[0] = kFar;
    o[pstride] = kFar;
    o[2 * pstride] = kNoBase;
    for (int q = 3; q < nrec; ++q) o[(size_t)q * pstride] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// march + exact tests + colfix: attrs (4, hpad, wl) for one frame: u, v,
// model z, coverage; with raster_z also the raster z (5, hpad, wl)
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

// One cell's exact coverage test and division-free winner fold (the JAX
// kernel's _cell_fold): the diagonal's sign picks the triangle, the nearer
// depth wins (cross-multiplied), ties go to the lower triangle id. CULL: the
// picked triangle's corner model-z spread (zm00 .. zm11) must be at most
// cull_thr; WIRE: the winner's least barycentric weight rides along.
template <bool CULL, bool WIRE>
__device__ __forceinline__ void cell_fold(
    Best& b, bool cell_ok, float diag_e, float top_e, float bottom_e,
    float left_e, float right_e, float z00, float z10, float z01, float z11,
    float i00, float i10, float i01, float i11, float u0, float u1,
    float v_top, float v_bot, float base_id, float inv_ncm1, float inv_nrm1,
    float zm00, float zm10, float zm01, float zm11, float cull_thr) {
  const bool d = diag_e >= 0.0f;
  const float w_a = d ? diag_e : bottom_e;
  const float w_b = d ? top_e : right_e;
  const float w_c = d ? left_e : -diag_e;
  const float area = (w_a + w_b) + w_c;
  bool ok = cell_ok && (area > 1e-12f);
  if (CULL) {
    const float zm_a = d ? zm00 : zm01;
    const float zm_c = d ? zm01 : zm11;
    const float spread = nan_max(nan_max(zm_a, zm10), zm_c) -
                         nan_min(nan_min(zm_a, zm10), zm_c);
    ok = ok && spread <= cull_thr;
  }
  const bool inside = (d && top_e >= 0.0f && left_e >= 0.0f) ||
                      (!d && bottom_e >= 0.0f && right_e >= 0.0f);
  const float z_a = d ? z00 : z01;
  const float z_c = d ? z01 : z11;
  const float znum = (w_a * z_a + w_b * z10) + w_c * z_c;
  const bool cov = ok && inside && (znum >= -area) && (znum <= area);
  const float tid = base_id + (d ? 0.0f : 1.0f);
  const float c_l = znum * b.ar;
  const float c_r = b.zn * area;
  if (cov && ((c_l < c_r) || ((c_l == c_r) && (tid < b.id)))) {
    const float p_a = w_a * (d ? i00 : i01);
    const float p_b = w_b * i10;
    const float p_c = w_c * (d ? i01 : i11);
    const float iw = (p_a + p_b) + p_c;
    b.zn = znum;
    b.ar = area;
    b.id = tid;
    b.uw = (d ? u0 : u1) * iw + inv_ncm1 * (d ? p_c : -p_b);
    b.vw = (d ? v_top : v_bot) * iw + inv_nrm1 * (d ? -p_b : p_a);
    b.iw = iw;
    if (WIRE) b.ml = fminf(w_a, fminf(w_b, w_c));
  }
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

// Bracket sweep over the column pairs (lo + c, lo + c + 1), c = 0 ..
// npair - 1, of one scanline's records: the first c of the nearest hit (0
// when no hit has a key below FAR), its key, and the hit count. ``skip``
// leaves one c out of the minimum (the second hypothesis).
__device__ void sweep(const float* sxr, const float* zcr, int lo, int npair,
                      float qx, int skip, int& o, float& m, int& cnt) {
  float best = kFar;
  int bi = 0, count = 0;
  for (int c = 0; c < npair; ++c) {
    const float a = sxr[lo + c];
    const float an = sxr[lo + c + 1];
    const bool hit = qx >= fminf(a, an) && qx <= fmaxf(a, an);
    const float key = (hit && c != skip) ? zcr[lo + c] : kFar;
    if (key < best) {
      best = key;
      bi = c;
    }
    count += hit ? 1 : 0;
  }
  o = bi;
  m = best;
  cnt = count;
}

// The reference's chunked march, for a march window of 4 or more 128-column
// chunks: per chunk of the window [ws, ws + mw), a block gate (some crossing
// x over the chunk and the next chunk's first 8 columns, at any of the
// block's 8 scanlines, at most the block's last pixel centre, and some real
// one at least its first pixel centre - 64) and a sweep over the chunk's 128
// pair bases (the window's last chunk: 127). Returns the first window column
// of the nearest hit in a gated chunk (mw if none), its key and the gated
// chunks' hit count. Block-uniform call.
__device__ void sweep_chunked(const float* sxr, const float* zcr, int ws,
                              int mw, int blk, float qx, int& o, float& m,
                              int& cnt) {
  const float qx0 = (float)(blk * 128) + 0.5f;
  const int x = threadIdx.x;
  const int nch = mw / 128;
  o = mw;
  m = kFar;
  cnt = 0;
  for (int ch = 0; ch < nch; ++ch) {
    const int lo = ws + ch * 128;
    const bool last = ch == nch - 1;
    const float v = sxr[lo + x];
    bool near = v <= qx0 + 127.0f;
    bool real = v < kHalfFar && v >= qx0 - 64.0f;
    if (!last && x < 8) {
      const float w = sxr[lo + 128 + x];
      near = near || w <= qx0 + 127.0f;
      real = real || (w < kHalfFar && w >= qx0 - 64.0f);
    }
    const bool any_near = __syncthreads_or(near);
    const bool any_real = __syncthreads_or(real);
    if (!(any_near && any_real)) continue;  // block-uniform
    int oc, cc;
    float mc;
    sweep(sxr, zcr, lo, last ? 127 : 128, qx, -1, oc, mc, cc);
    if (mc < m) {
      m = mc;
      o = ch * 128 + oc;
    }
    cnt += cc;
  }
}

// Exact tests of the record picked by march hypothesis h (a march-window
// column, clamped to [0, mw - 1]) and its right neighbour: with dual_col the
// right column's corners stored in the same record, else the neighbour
// record realigned by the bracket-row delta. ``slot`` points at the slot's
// planes at the pixel's scanline.
template <bool CULL, bool WIRE>
__device__ void exact_record(const ScanParams& p, Best& b, const float* slot,
                             float h, int mw, int canch_f, int off_f,
                             float w0f, float qx, float qy) {
  const size_t ps = (size_t)8 * p.cl;  // record plane stride
  const int pr = p.dual ? 6 : 3;       // record planes per strip row
  const int j1 = (int)fclamp(h, 0.0f, (float)(mw - 1)) + off_f;
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

  float x00, y00, z00, x01, y01, z01;
  strip1(0, x00, y00, z00);
  strip2(0, x01, y01, z01);
  float i00 = inv_w_of(p, x00, y00, z00);
  float i01 = inv_w_of(p, x01, y01, z01);
  float zm00 = 0.0f, zm01 = 0.0f;
  if (CULL) {
    zm00 = model_z(p, x00, y00, z00);
    zm01 = model_z(p, x01, y01, z01);
  }
  float prev_bottom = 0.0f;
  for (int k = 0; k < p.sr - 1; ++k) {
    float x10, y10, z10, x11, y11, z11;
    strip1(k + 1, x10, y10, z10);
    strip2(k + 1, x11, y11, z11);
    const float i10 = inv_w_of(p, x10, y10, z10);
    const float i11 = inv_w_of(p, x11, y11, z11);
    float zm10 = 0.0f, zm11 = 0.0f;
    if (CULL) {
      zm10 = model_z(p, x10, y10, z10);
      zm11 = model_z(p, x11, y11, z11);
    }
    const float r_cell = rg0 + (float)k;
    const bool cell_ok =
        col_ok && r_cell >= 0.0f && r_cell <= (float)(p.n_r - 2);
    const float v_top = 1.0f - r_cell * p.inv_nrm1;
    const float v_bot = 1.0f - (r_cell + 1.0f) * p.inv_nrm1;
    const float base_id = (r_cell * (float)(p.n_c - 1) + cg) * 2.0f;
    const float diag_e = edge_fn(x10, y10, x01, y01, qx, qy);
    const float left_e = edge_fn(x00, y00, x10, y10, qx, qy);
    const float top_e =
        k == 0 ? edge_fn(x01, y01, x00, y00, qx, qy) : -prev_bottom;
    const float bottom_e = edge_fn(x10, y10, x11, y11, qx, qy);
    const float right_e = edge_fn(x11, y11, x01, y01, qx, qy);
    prev_bottom = bottom_e;
    cell_fold<CULL, WIRE>(b, cell_ok, diag_e, top_e, bottom_e, left_e,
                          right_e, z00, z10, z01, z11, i00, i10, i01, i11, u0,
                          u1, v_top, v_bot, base_id, p.inv_ncm1, p.inv_nrm1,
                          zm00, zm10, zm01, zm11, p.cull_thr);
    x00 = x10; y00 = y10; z00 = z10; i00 = i10; zm00 = zm10;
    x01 = x11; y01 = y11; z01 = z11; i01 = i11; zm01 = zm11;
  }
}

// One colfix fan call for one slot (block-uniform call): re-test every
// scanned window row over the fan's cells around the slot's top-1 column j0.
// The corner columns are j0 + offs[cc]; cells lie between consecutive offsets
// only (the K >= 2 outer fan has a gap where the inner fan's cells were).
// Rows are the band window's (BIG: global grid rows, and each cell also
// needs the row inside the scan rows of the chunks its two corner columns
// land in).
template <int NF, bool BIG, bool CULL, bool WIRE>
__device__ void colfix_slot(const ScanParams& p, Best& b,
                            const float* __restrict__ win,
                            const int* __restrict__ bounds, int band,
                            int mw, int canch_f, int off_f, int wbase,
                            float w0f, float h1, float m1, float qx, float qy,
                            const int (&offs)[NF]) {
  const bool hitok = m1 < kHalfFar;
  const int j0 = (int)fclamp(h1, 0.0f, (float)(mw - 1)) + off_f;
  const int rows = BIG ? p.rpad : p.rmax;  // rows of the window read
  int col[NF], sub[NF];
  bool colok[NF];
  float cg[NF];
#pragma unroll
  for (int cc = 0; cc < NF; ++cc) {
    const int ix = j0 + offs[cc];
    colok[cc] = hitok && ix >= 0 && ix <= p.cwf - 1;
    sub[cc] = iclamp(ix, 0, p.cwf - 1) / 128;
    col[cc] = canch_f * 128 + iclamp(ix, 0, p.cwf - 1);
    cg[cc] = (float)col[cc];
  }
  // Row bounds: the union of the scan rows of every chunk a valid fan
  // corner of the block lands in.
  int kb_u = rows, ke_u = 0;
  const int nsub = p.cwf / 128;
  for (int tt = 0; tt < nsub; ++tt) {
    bool mine = false;
#pragma unroll
    for (int cc = 0; cc < NF; ++cc)
      mine = mine || (colok[cc] && sub[cc] == tt);
    if (__syncthreads_or(mine)) {
      const ChunkRows cr =
          chunk_rows(p, bounds[band * p.nchunks + canch_f + tt]);
      if (cr.ke > cr.kb) {
        kb_u = imin(kb_u, cr.origin + cr.kb);
        ke_u = imax(ke_u, cr.origin + cr.ke);
      }
    }
  }
  int lo_c[NF], hi_c[NF];  // BIG: each corner's chunk rows
  if constexpr (BIG) {
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      const ChunkRows cr =
          chunk_rows(p, bounds[band * p.nchunks + canch_f + sub[cc]]);
      const bool ne = cr.ke > cr.kb;
      lo_c[cc] = ne ? cr.origin + cr.kb : rows;
      hi_c[cc] = ne ? cr.origin + cr.ke : 0;
    }
  }
  const int k_lo = imin(kb_u / 8, rows / 8 - 1) * 8;
  const int k_hi = imin((ke_u + 8) / 8, rows / 8) * 8;
  const size_t plane = (size_t)p.rpad * p.cl;

  float tx[NF], ty[NF], tz[NF], ti[NF];  // the current row's fan corners
  float tm[NF];                          // and their model z (CULL)
  float prev_bottom[NF];                 // per cell f (between f and f + 1)
#pragma unroll
  for (int f = 0; f < NF; ++f) prev_bottom[f] = 0.0f;
  if (k_lo < k_hi) {
    const size_t r = (size_t)(wbase + k_lo) * p.cl;
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      tx[cc] = win[r + col[cc]];
      ty[cc] = win[plane + r + col[cc]];
      tz[cc] = win[2 * plane + r + col[cc]];
      ti[cc] = inv_w_of(p, tx[cc], ty[cc], tz[cc]);
      tm[cc] = CULL ? model_z(p, tx[cc], ty[cc], tz[cc]) : 0.0f;
    }
  }
  for (int k = k_lo; k < k_hi; ++k) {
    // Row k+1 past the band window re-reads the last 8-row block's first
    // row (the reference's clamped block load), past the padded grid the
    // last row; such rows are masked.
    const int kn = k + 1 >= rows ? (BIG ? rows - 1 : rows - 8) : k + 1;
    const size_t r = (size_t)(wbase + kn) * p.cl;
    float bx[NF], by[NF], bz[NF], bi[NF], lines[NF];
    float bm[NF];
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      bx[cc] = win[r + col[cc]];
      by[cc] = win[plane + r + col[cc]];
      bz[cc] = win[2 * plane + r + col[cc]];
      bi[cc] = inv_w_of(p, bx[cc], by[cc], bz[cc]);
      bm[cc] = CULL ? model_z(p, bx[cc], by[cc], bz[cc]) : 0.0f;
      lines[cc] = edge_fn(tx[cc], ty[cc], bx[cc], by[cc], qx, qy);
    }
    const float r_cell = w0f + (float)k;
    const bool row_ok = k >= kb_u && k < ke_u && r_cell >= 0.0f &&
                        r_cell <= (float)(p.n_r - 2);
    const float v_top = 1.0f - r_cell * p.inv_nrm1;
    const float v_bot = 1.0f - (r_cell + 1.0f) * p.inv_nrm1;
#pragma unroll
    for (int f = 0; f + 1 < NF; ++f) {
      if (offs[f + 1] != offs[f] + 1) continue;  // the outer fan's gap
      bool cell_ok = row_ok && colok[f] && colok[f + 1] &&
                     cg[f] <= (float)(p.n_c - 2);
      if constexpr (BIG)
        cell_ok = cell_ok && k >= lo_c[f] && k < hi_c[f] &&
                  k >= lo_c[f + 1] && k < hi_c[f + 1];
      const float u0 = cg[f] * p.inv_ncm1;
      const float u1 = (cg[f] + 1.0f) * p.inv_ncm1;
      const float base_id = (r_cell * (float)(p.n_c - 1) + cg[f]) * 2.0f;
      const float diag_e = edge_fn(bx[f], by[f], tx[f + 1], ty[f + 1], qx,
                                   qy);
      const float top_e =
          k == k_lo ? edge_fn(tx[f + 1], ty[f + 1], tx[f], ty[f], qx, qy)
                    : -prev_bottom[f];
      const float bottom_e = edge_fn(bx[f], by[f], bx[f + 1], by[f + 1], qx,
                                     qy);
      prev_bottom[f] = bottom_e;
      cell_fold<CULL, WIRE>(
          b, cell_ok, diag_e, top_e, bottom_e, lines[f], -lines[f + 1], tz[f],
          bz[f], tz[f + 1], bz[f + 1], ti[f], bi[f], ti[f + 1], bi[f + 1], u0,
          u1, v_top, v_bot, base_id, p.inv_ncm1, p.inv_nrm1, tm[f], bm[f],
          tm[f + 1], bm[f + 1], p.cull_thr);
    }
#pragma unroll
    for (int cc = 0; cc < NF; ++cc) {
      tx[cc] = bx[cc];
      ty[cc] = by[cc];
      tz[cc] = bz[cc];
      ti[cc] = bi[cc];
      tm[cc] = bm[cc];
    }
  }
}

// One fan call over every slot, each gated on the block still holding an
// uncovered pixel with a real marched bracket in that slot.
template <int NF, bool BIG, bool CULL, bool WIRE>
__device__ void colfix_pass(const ScanParams& p, Best& b,
                            const float* __restrict__ win,
                            const int* __restrict__ bounds, int band, int mw,
                            int canch_f, int off_f, int wbase, float w0f,
                            const float* fix_h, const float* fix_m, float qx,
                            float qy, const int (&offs)[NF]) {
  for (int s = 0; s < p.nbr; ++s) {
    if (__syncthreads_or(b.id >= 1.0e30f && fix_m[s] < kHalfFar))
      colfix_slot<NF, BIG, CULL, WIRE>(p, b, win, bounds, band, mw, canch_f,
                                       off_f, wbase, w0f, fix_h[s], fix_m[s],
                                       qx, qy, offs);
  }
}

template <bool BIG, bool CULL, bool WIRE>
__global__ void __launch_bounds__(1024, 1)
march_kernel(const float* __restrict__ rec, const float* __restrict__ win,
             const int* __restrict__ w0, const int* __restrict__ bounds,
             const int* __restrict__ canch, const int* __restrict__ mid,
             const int* __restrict__ bflag, float* __restrict__ attrs,
             ScanParams p) {
  const int blk = blockIdx.x, band = blockIdx.y;
  const int x = threadIdx.x, y = threadIdx.y;
  const size_t o = (size_t)(band * 8 + y) * p.wl + blk * 128 + x;
  const size_t ap = (size_t)p.hpad * p.wl;
  if (bflag != nullptr && bflag[band] == 0) {  // sparse band: uncovered
    for (int a = 0; a < 4; ++a) attrs[a * ap + o] = 0.0f;
    if (p.raster_z) attrs[4 * ap + o] = kFar;
    return;
  }
  const float qx = ((float)(blk * 128) + (float)x) + 0.5f;
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

  Best b = {kFar, 1.0f, kIdNone, 0.0f, 0.0f, 0.0f, 0.0f};
  float fix_h[4], fix_m[4];

  for (int s = 0; s < p.nbr; ++s) {
    // This slot's record planes at scanline y (plane stride ps).
    const float* slot =
        rec + ((size_t)band * p.nbr + s) * nrec * ps + (size_t)y * p.cl;
    const float* sxr = slot;       // crossing x
    const float* zcr = slot + ps;  // crossing z
    fix_h[s] = (float)mw;
    fix_m[s] = kFar;
    if (midv == -2) continue;  // block-uniform: no candidates, or gated
    // Slot gate: any record in the block's march window (its narrow window
    // when the block marches narrow), over all 8 rows.
    bool mine = false;
    for (int c = x; c < mw; c += 128) mine = mine || zcr[ws + c] < kHalfFar;
    bool any_rec = __syncthreads_or(mine);
    const int lo_n = canch_m + imax(midv, 0) * 8;
    if (narrow_ok) {
      const bool any_nar = __syncthreads_or(zcr[lo_n + x] < kHalfFar);
      if (midv >= 0) any_rec = any_nar;
    }
    if (!any_rec) continue;  // block-uniform

    int o1, cnt;
    float m1, shift = 0.0f;
    const bool narrow = narrow_ok && midv >= 0;
    const int lo = narrow ? lo_n : ws;
    const int len = narrow ? 128 : mw;
    if (chunked) {
      sweep_chunked(sxr, zcr, ws, mw, blk, qx, o1, m1, cnt);
    } else {
      sweep(sxr, zcr, lo, len - 1, qx, -1, o1, m1, cnt);
      shift = narrow ? (float)(midv * 8) : 0.0f;
    }
    const float h1 = (float)o1 + shift;
    exact_record<CULL, WIRE>(p, b, slot, h1, mw, canch_f, off_f, w0f, qx,
                             qy);
    if (need2 && __syncthreads_or(cnt > 1)) {
      // The second hypothesis: the nearest hit but the window's first one
      // (a chunked march re-sweeps the whole window for both).
      int od = o1, o2, c2;
      float m2;
      if (chunked) sweep(sxr, zcr, lo, len - 1, qx, -1, od, m2, c2);
      sweep(sxr, zcr, lo, len - 1, qx, od, o2, m2, c2);
      exact_record<CULL, WIRE>(p, b, slot, (float)o2 + shift, mw, canch_f,
                               off_f, w0f, qx, qy);
    }
    fix_h[s] = h1;
    fix_m[s] = m1;
  }

  // The colfix cascade: the inner fan (K = 0: the one cell j0; K >= 1:
  // cells j0-1 .. j0+1), then at K >= 2 the outer cells where holes remain.
  if (p.colfix == 0) {
    const int inner0[2] = {0, 1};
    colfix_pass<2, BIG, CULL, WIRE>(p, b, win, bounds, band, mw, canch_f,
                                    off_f, wbase, w0f, fix_h, fix_m, qx, qy,
                                    inner0);
  } else if (p.colfix > 0) {
    const int inner[4] = {-1, 0, 1, 2};
    colfix_pass<4, BIG, CULL, WIRE>(p, b, win, bounds, band, mw, canch_f,
                                    off_f, wbase, w0f, fix_h, fix_m, qx, qy,
                                    inner);
    if (p.colfix == 2) {
      const int outer2[4] = {-2, -1, 2, 3};
      colfix_pass<4, BIG, CULL, WIRE>(p, b, win, bounds, band, mw, canch_f,
                                      off_f, wbase, w0f, fix_h, fix_m, qx,
                                      qy, outer2);
    } else if (p.colfix == 3) {
      const int outer3[6] = {-3, -2, -1, 2, 3, 4};
      colfix_pass<6, BIG, CULL, WIRE>(p, b, win, bounds, band, mw, canch_f,
                                      off_f, wbase, w0f, fix_h, fix_m, qx,
                                      qy, outer3);
    }
  }

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
  if (WIRE) cov = cov && b.ml <= kWireEdge * b.ar;
  attrs[o] = u;
  attrs[ap + o] = v;
  attrs[2 * ap + o] = zm;
  attrs[3 * ap + o] = cov ? 1.0f : 0.0f;
  if (p.raster_z) attrs[4 * ap + o] = bz;
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

int scan_solve(const void* win, const void* w0, const void* bounds,
               const void* bflag, void* rec, const ScanParams* p,
               void* stream) {
  dim3 grid(p->nchunks, p->nbands), block(128, 8);
  solve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)win, (const int*)w0, (const int*)bounds,
      (const int*)bflag, (float*)rec, *p);
  return (int)cudaGetLastError();
}

int scan_march(const void* rec, const void* win, const void* w0,
               const void* bounds, const void* canch, const void* mid,
               const void* bflag, void* attrs, const ScanParams* p,
               void* stream) {
  dim3 grid(p->nblk, p->nbands), block(128, 8);
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
