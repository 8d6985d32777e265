// The tiled rasteriser's pixel x triangle pass as a CUDA kernel.
//
// Replaces the TPU kernel depthrenderer_tpu/ops/raster_pallas.py::_pair_kernel
// (one Pallas grid step per 8x128 screen tile, an inner loop over the tile's
// active triangle chunks). For every pixel of a tile and every triangle of
// each active chunk [jlo, jhi) it evaluates the λ0, λ1, λ2 and z planes
// qx*A + qy*B + C, tests coverage (all λ >= 0, -1 <= z <= 1), keeps the
// first strict minimum of z (the lowest triangle id wins ties), evaluates the
// chunk winner's u/w, v/w, 1/w and zm/w planes and its min-λ, and merges the
// chunk into the running best by strict < (earlier chunks win ties). The tile
// ends with the den guard (|1/w| > 1e-30) and the 8-wide output row
// (u, v, z_model, coverage, best z, min-λ, 0, 0).
//
// Launch shape: one block per (tile, anchor pass), tile_h * tile_w threads
// (1,024 for 8x128), one per pixel. The TPU kernel's sequential chunk grid is
// the block's own loop; its one-hot MXU dot that picks the winner's attribute
// planes is a plain index into shared memory (the one-hot dot at HIGHEST
// precision picks the coefficient exactly, so the value is the same).
//
// Numerics: the file is compiled with --fmad=false, and every expression is
// written in the JAX kernel's order of operations, so each result equals the
// plain twin's (ops/tiled.py::raster_pairs_plain) bit for bit. XLA's
// CPU backend contracts the JAX kernel's qx*A + qy*B + C (planes and the
// winner's attributes alike) into fma(qx, A, qy*B) + C; that one fused
// multiply-add is an explicit fmaf here and an exact emulation in the twin.
//
// What bounds it on an H100, and what the design does about it: the work is
// ~30 float operations per active (pixel, triangle) pair against 96 bytes of
// planes per triangle shared by the tile's 1,024 pixels, so it is bound by
// operations, not bytes. Each chunk's cov and attr planes (2 x 12 x TC
// floats, 24 KB at TC = 256) are staged once in shared memory and read as
// broadcasts (every thread of a warp reads the same triangle). Keeping
// triangle tiles in registers, double-buffering chunks with cp.async or TMA,
// and building the planes in the kernel are later work; this version is the
// simple, exact one.

#include <cuda_runtime.h>

namespace {

constexpr float kFar = 3.0e38f;  // FAR_SENTINEL

// Plane k of triangle i at (qx, qy): fma(qx, A, qy*B) + C.
__device__ __forceinline__ float plane(const float* s, int tc, int k, int i,
                                       float qx, float qy) {
  return fmaf(qx, s[3 * k * tc + i], qy * s[(3 * k + 1) * tc + i]) +
         s[(3 * k + 2) * tc + i];
}

}  // namespace

// Mirror of ops/tiled.py::_PairParams (field order and types must
// match).
struct PairParams {
  int ntiles, nchunks, tc, tile_h, tile_w, height;
};

__global__ void __launch_bounds__(1024)
pair_kernel(const float* __restrict__ cov, const float* __restrict__ attr,
            const int* __restrict__ px0, const int* __restrict__ py0,
            const int* __restrict__ jlo, const int* __restrict__ jhi,
            float* __restrict__ out, PairParams p) {
  extern __shared__ float smem[];
  const int tc = p.tc;
  const int chunk_floats = 12 * tc;
  float* scov = smem;
  float* sattr = smem + chunk_floats;

  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const float qx = ((float)px0[t] + (float)(pix % p.tile_w)) + 0.5f;
  const float qy =
      (float)p.height - (((float)py0[t] + (float)(pix / p.tile_w)) + 0.5f);

  float best_z = kFar;
  float best[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const size_t tile_off = (size_t)t * p.nchunks * chunk_floats;
  const int j1 = jhi[t];
  for (int j = jlo[t]; j < j1; ++j) {
    __syncthreads();  // every thread is done with the previous chunk
    const float* gc = cov + tile_off + (size_t)j * chunk_floats;
    const float* ga = attr + tile_off + (size_t)j * chunk_floats;
    for (int e = threadIdx.x; e < chunk_floats; e += blockDim.x) {
      scov[e] = gc[e];
      sattr[e] = ga[e];
    }
    __syncthreads();

    float cb = kFar, ml = 0.f;
    int sel = 0;
    for (int i = 0; i < tc; ++i) {
      const float l0 = plane(scov, tc, 0, i, qx, qy);
      const float l1 = plane(scov, tc, 1, i, qx, qy);
      const float l2 = plane(scov, tc, 2, i, qx, qy);
      const float zz = plane(scov, tc, 3, i, qx, qy);
      const bool covered = l0 >= 0.f && l1 >= 0.f && l2 >= 0.f &&
                           zz >= -1.f && zz <= 1.f;
      if (covered && zz < cb) {
        cb = zz;
        sel = i;
        ml = fminf(l0, fminf(l1, l2));
      }
    }
    if (cb < best_z) {
      for (int a = 0; a < 4; ++a) {
        best[a] = fmaf(sattr[3 * a * tc + sel], qx,
                       sattr[(3 * a + 1) * tc + sel] * qy) +
                  sattr[(3 * a + 2) * tc + sel];
      }
      best[4] = ml;
      best_z = cb;
    }
  }

  const float den = fabsf(best[2]) > 1e-30f ? best[2] : 1.f;
  float* o = out + ((size_t)t * blockDim.x + pix) * 8;
  o[0] = best[0] / den;
  o[1] = best[1] / den;
  o[2] = best[3] / den;
  o[3] = best_z < kFar ? 1.f : 0.f;
  o[4] = best_z;
  o[5] = best[4];
  o[6] = 0.f;
  o[7] = 0.f;
}

extern "C" {

const char* pair_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int pair_raster(const void* cov, const void* attr, const void* px0,
                const void* py0, const void* jlo, const void* jhi, void* out,
                const PairParams* p, void* stream) {
  const int P = p->tile_h * p->tile_w;
  if (P <= 0 || P > 1024 || p->tc <= 0) return (int)cudaErrorInvalidValue;
  if (p->ntiles == 0) return 0;
  const size_t smem = (size_t)2 * 12 * p->tc * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_kernel<<<p->ntiles, P, smem, (cudaStream_t)stream>>>(
      (const float*)cov, (const float*)attr, (const int*)px0,
      (const int*)py0, (const int*)jlo, (const int*)jhi, (float*)out, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
