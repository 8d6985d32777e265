// The tiled rasteriser's pixel x triangle pass as a CUDA kernel.
//
// Replaces the TPU kernel depthrenderer_tpu/ops/raster_pallas.py::_pair_kernel
// (one Pallas grid step per 8x128 screen tile, an inner loop over the tile's
// active triangle chunks). For every pixel of a tile and every triangle of
// each active chunk [jlo, jhi) it evaluates the λ0, λ1, λ2 and z planes
// qx*A + qy*B + C, tests coverage (all λ >= 0, -1 <= z <= 1) and keeps the
// first strict minimum of z over the tile's chunks in order (the lowest
// chunk, then the lowest slot, wins ties: the TPU kernel's first minimum of
// a chunk merged into the running best by strict <). The winner's u/w, v/w,
// 1/w and zm/w planes and its min-λ give the 8-wide output row after the den
// guard (|1/w| > 1e-30): u, v, z_model, coverage, best z, min-λ, 0, 0.
//
// Planes in place. The kernel reads the frame group's plane tables, cov and
// attr, each (F, 12, N) float32 (N = 2 * cells + 1 columns a row; the TPU
// kernel's BlockSpec needed per-tile window copies, a Hopper block does not).
// A tile has ``wpt`` windows (1 on the Pallas route; the row anchors on the
// grid route); its chunk j is window w = j / nch, relative row r = j % nch:
// slot i holds table column origin[t * wpt + w] + rel[r][i] (origin is int64
// with the frame's offset f * 12 * N folded in), or the never-covered plane
// where rel is -1.
//
// Launch shape: one block of 32 * tile_h * ceil(tile_w / 128) threads (256
// for 8x128) per tile; a warp covers 128 columns of one pixel row, each
// thread 4 pixels 32 columns apart, so the 4 share qy and each qy*B product
// is computed once for them. A chunk's cov planes are staged triangle-major
// (three float4 a triangle) by cp.async into one of two shared buffers while
// the block computes on the other; every warp reads the same triangle, so a
// triangle's coefficients are 16-byte broadcast loads serving 4 pixels. The
// tests go in stages, each behind a warp vote (a warp-uniform branch): λ0;
// then λ1 and λ2 where a lane of the warp meets λ0; then z where a lane is
// inside the triangle. A half-plane misses all 128 pixels of a warp for
// many of a window's triangles, and few triangles hold any of them. Per
// pixel the block keeps one running (best z, chunk, slot): a strict < scan
// over (chunk, slot) in order is the TPU kernel's per-chunk first minimum
// merged by strict <. The winner's attributes and min-λ are evaluated once
// per pixel at the end from the tables; attr is never staged. z <= 1 is
// folded into the running test: best z starts one ulp above 1, so z < best
// is z <= 1 until a triangle covers the pixel and z < best after.
//
// Numerics: the file is compiled with --fmad=false, and every expression is
// written in the JAX kernel's order of operations, so each result equals the
// plain twin's (ops/tiled.py::raster_pairs_plain) bit for bit. XLA's CPU
// backend contracts the JAX kernel's qx*A + qy*B + C (planes and the
// winner's attributes alike) into fma(qx, A, qy*B) + C; that one fused
// multiply-add is an explicit fmaf here and an exact emulation in the twin.
//
// What bounds it on an H100: operations. Every active (pixel, triangle) pair
// needs the three λ planes and their tests, 3 fma + 3 add + 3 comparisons
// (12 FP32 operations, an fma counted twice); z only for the few pairs
// inside their triangle. Against that, 48 bytes of cov per triangle serve
// the tile's 1,024 pixels and come from L2 once per chunk. The staged tests
// skip much of that work, but each stage adds its vote, products and shared
// loads, so the issue rate is the limit. The three tests behind one vote,
// each behind its own, two rows a thread (8 pixels) and unrolling by 4 were
// measured no faster.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFar = 3.0e38f;  // FAR_SENTINEL
constexpr int kThreads = 256;    // the most threads a block (8x128 tiles)
constexpr int kPix = 4;          // pixels a thread, 32 columns apart
constexpr int kSeg = 32 * kPix;  // columns a warp covers

// One float of a chunk's cov planes into shared memory: a 4-byte cp.async
// on the card (the staging of the next chunk overlaps this one's compute).
__device__ __forceinline__ void stage(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

}  // namespace

// Mirror of ops/tiled.py::_PairParams (field order and types must match).
struct PairParams {
  long long nstride;  // N: columns of a table row
  int ntiles, wpt, nch, tc, tile_h, tile_w, height;
};

// Stage chunk j of a tile (windows ``org``) into ``dst``: triangle i's 12
// cov coefficients at dst[3 i .. 3 i + 2] (A0 B0 C0 A1 | B1 C1 A2 B2 |
// C2 Az Bz Cz); padding slots get the never-covered plane (λ0 C = -1,
// z C = FAR), which no pixel covers.
__device__ __forceinline__ void stage_chunk(float4* dst, const float* cov,
                                            const long long* org,
                                            const int* rel, int j,
                                            const PairParams& p) {
  const int w = j / p.nch;
  const long long o = org[w];
  const int* rr = rel + (long long)(j - w * p.nch) * p.tc;
  for (int i = threadIdx.x; i < p.tc; i += blockDim.x) {
    float* d = reinterpret_cast<float*>(dst + 3 * i);
    const int rc = rr[i];
    if (rc < 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) d[k] = 0.f;
      d[2] = -1.f;
      d[11] = kFar;
    } else {
      const float* s = cov + (o + rc);
#pragma unroll
      for (int k = 0; k < 12; ++k) stage(d + k, s + k * p.nstride);
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ cov, const float* __restrict__ attr,
            const long long* __restrict__ origin, const int* __restrict__ rel,
            const int* __restrict__ px0, const int* __restrict__ py0,
            const int* __restrict__ jlo, const int* __restrict__ jhi,
            float* __restrict__ out, PairParams p) {
  extern __shared__ float4 pair_smem[];  // two chunks of 3 * tc float4
  const int t = blockIdx.x;
  const int segs = (p.tile_w + kSeg - 1) / kSeg;
  const int warp = threadIdx.x / 32;
  const int row = warp / segs;
  const int col0 = (warp % segs) * kSeg + threadIdx.x % 32;
  const float qy = (float)p.height - (((float)py0[t] + (float)row) + 0.5f);
  float qx[kPix], best[kPix];
  int bchunk[kPix], bslot[kPix];
  const float z_cap = __int_as_float(0x3f800001);  // one ulp above 1
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    qx[q] = ((float)px0[t] + (float)(col0 + 32 * q)) + 0.5f;
    best[q] = z_cap;
    bchunk[q] = -1;
    bslot[q] = 0;
  }

  const long long* org = origin + (long long)t * p.wpt;
  const int j0 = jlo[t], j1 = jhi[t];
  if (j0 < j1) stage_chunk(pair_smem, cov, org, rel, j0, p);
  for (int j = j0; j < j1; ++j) {
    const float4* cur = pair_smem + ((j - j0) & 1) * 3 * p.tc;
    if (j + 1 < j1) {
      // The other buffer was last read before the previous barrier.
      stage_chunk(pair_smem + ((j + 1 - j0) & 1) * 3 * p.tc, cov, org, rel,
                  j + 1, p);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk j is in shared memory for every thread

    int slot[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) slot[q] = -1;
#pragma unroll 2
    for (int i = 0; i < p.tc; ++i) {
      // λ0, then λ1 and λ2, then z, each stage behind a warp vote.
      const float4 a = cur[3 * i];
      bool in[kPix];
      bool any = false;
      const float yb0 = qy * a.y;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        in[q] = fmaf(qx[q], a.x, yb0) + a.z >= 0.f;
        any = any || in[q];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      const float4 b = cur[3 * i + 1];
      const float c0 = reinterpret_cast<const float*>(cur + 3 * i + 2)[0];
      const float yb1 = qy * b.x, yb2 = qy * b.w;
      any = false;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        in[q] = in[q] && fmaf(qx[q], a.w, yb1) + b.y >= 0.f &&
                fmaf(qx[q], b.z, yb2) + c0 >= 0.f;
        any = any || in[q];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      const float4 c = cur[3 * i + 2];
      const float ybz = qy * c.z;
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float zz = fmaf(qx[q], c.y, ybz) + c.w;
        if (in[q] && zz >= -1.f && zz < best[q]) {
          best[q] = zz;
          slot[q] = i;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (slot[q] >= 0) {
        bchunk[q] = j;
        bslot[q] = slot[q];
      }
    }
    __syncthreads();  // every thread is done with chunk j's buffer
  }

  const long long n = p.nstride;
  const int P = p.tile_h * p.tile_w;
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int col = col0 + 32 * q;
    if (col >= p.tile_w) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    float ml = 0.f, bz = kFar;
    if (bchunk[q] >= 0) {
      const int w = bchunk[q] / p.nch;
      const int r = bchunk[q] - w * p.nch;
      const long long c = org[w] + rel[(long long)r * p.tc + bslot[q]];
      const float* cv = cov + c;
      const float* at = attr + c;
      float l[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        l[k] = fmaf(qx[q], cv[3 * k * n], qy * cv[(3 * k + 1) * n]) +
               cv[(3 * k + 2) * n];
      ml = fminf(l[0], fminf(l[1], l[2]));
#pragma unroll
      for (int a = 0; a < 4; ++a)
        v[a] = fmaf(at[3 * a * n], qx[q], at[(3 * a + 1) * n] * qy) +
               at[(3 * a + 2) * n];
      bz = best[q];
    }
    const float den = fabsf(v[2]) > 1e-30f ? v[2] : 1.f;
    float4* o = reinterpret_cast<float4*>(
        out + ((long long)t * P + row * p.tile_w + col) * 8);
    o[0] = make_float4(v[0] / den, v[1] / den, v[3] / den,
                       bz < kFar ? 1.f : 0.f);
    o[1] = make_float4(bz, ml, 0.f, 0.f);
  }
}

extern "C" {

const char* pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Threads of a block for this tile shape (0 if the kernel does not take it).
int pair_threads(int tile_h, int tile_w) {
  const int threads = 32 * tile_h * ((tile_w + kSeg - 1) / kSeg);
  return tile_h > 0 && tile_w > 0 && threads <= kThreads ? threads : 0;
}

int pair_raster(const void* cov, const void* attr, const void* origin,
                const void* rel, const void* px0, const void* py0,
                const void* jlo, const void* jhi, void* out,
                const PairParams* p, void* stream) {
  const int threads = pair_threads(p->tile_h, p->tile_w);
  if (threads == 0 || p->tc <= 0 || p->wpt <= 0 || p->nch <= 0)
    return (int)cudaErrorInvalidValue;
  if (p->ntiles == 0) return 0;
  const size_t smem = (size_t)2 * 3 * p->tc * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_kernel<<<p->ntiles, threads, smem, (cudaStream_t)stream>>>(
      (const float*)cov, (const float*)attr, (const long long*)origin,
      (const int*)rel, (const int*)px0, (const int*)py0, (const int*)jlo,
      (const int*)jhi, (float*)out, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
