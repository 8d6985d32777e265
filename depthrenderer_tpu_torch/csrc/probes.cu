// Hopper micro-benchmarks of on-chip gathers and of the march's core: the
// CUDA counterparts of the TPU probe kernels in experiments/ (ROADMAP K3).
//
// Replaces the 19 pl.pallas_call sites of experiments/gather_probe.py ...
// gather_probe10.py and experiments/scan_probe_march.py with five kernels;
// depthrenderer_tpu_torch/probes/__init__.py maps every probe builder to a
// named case with its shapes, index form and trip counts.
//
//   gather_accum  every gather probe (and scan_probe_march P3, P3b, P3c):
//                 one thread per output element sums, over the trips and the
//                 unrolled index sets, a value gathered from a table staged
//                 in shared memory (the card's counterpart of VMEM). Index
//                 forms: static, & mask, (+ trip) & mask (the probes'
//                 (idx + i) % n for a power-of-two n and idx + i >= 0, where
//                 the two are equal), the two-subtable clip and the &255
//                 two-subtable select; along rows (lane), along columns
//                 (sublane) or over the flat table; f32, u32 (cast to f32),
//                 i32 (wrapping sum) or the low 16 bits of the f32 bits;
//                 1 or 8 tables, 1 or 4 rotating accumulators; the baselines
//                 without a gather (multiply-add, index convert).
//   roll_accum    gather_probe5 build_roll: out[s, l] += t[s, (l - sh) mod C],
//                 jnp.roll's convention, with a per-set traced shift.
//   onehot_dot    gather_probe build_onehot_mxu: the one-hot contraction done
//                 as dense f32 multiply-adds over every cell of a table in
//                 shared memory (not a shortcut to a gather).
//   transpose     scan_probe_march P1.
//   march_top2    scan_probe_march P2: per row y and pixel l the dense sign
//                 test over the row's C crossing columns and the top 2 keys
//                 with their lowest column index, summed over the trips.
//
// Layout: the TPU probes held whole (S, 128) tiles in vector registers; here
// a block of threads covers a tile of output elements and stages the slice of
// the table its threads read: a lane gather reads its thread's table row, so
// a block stages its rows (bs rows x all columns, of every table); a sublane
// gather reads its thread's column, so a block stages all rows of its bl
// columns; the flat gather stages the whole table. Where there is more than
// one index set (the unrolled probes), the block stages its sets too; one
// set stays in a register. The host (probes/__init__.py::gather_geometry)
// picks bs and bl.
//
// What bounds them on an H100: a gather is one shared-memory word per lookup
// per thread, 32 words a clock per SM when the 32 lanes of a warp hit 32
// banks; a random lane index into a table row hits random banks (a sublane
// gather with 32-column slices hits bank = lane, none), so the probes
// measure the conflicts too. The baselines and onehot_dot are bound by FP32
// at 128 multiply-adds a clock per SM, the transpose by device memory. The
// kernels are the simple exact form; nothing here is tuned.
//
// Numerics: built with --fmad=false; every sum is taken in the probe's order
// (sequential f32 adds per accumulator, a0 + a1 + a2 + a3 at the end), so
// each result equals its plain PyTorch twin (depthrenderer_tpu_torch/probes/
// gather.py, march.py) bit for bit. XLA's CPU backend contracts the
// baseline's acc + t * x into fma(t, x, acc): that is fmaf here. The i32 sum
// is taken in uint32, so its wrap is defined.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Mirror of probes/__init__.py::ProbeParams (field order and types must
// match). Table (ntab, R, C); output (S, L); index sets (unroll, ., .) with
// element strides idx_us, idx_ss, idx_ls (idx_ls = 0 broadcasts a column).
// gather_accum, roll_accum and march_top2 compute `copies` identical
// outputs, one per blockIdx.z, to fill more of the card than the probe's one
// tile does.
struct ProbeParams {
  int form, axis, dtype, naccs;
  int S, L, ntab, R, C, unroll;
  int idx_us, idx_ss, idx_ls;
  int mask, trips, bs, bl, copies;
};

namespace {

enum Form { kStatic, kMask, kAddMask, kClip2, kAnd2, kFma, kConvert };
enum Axis { kLane, kSublane, kFlat };
enum Dtype { kF32, kU32, kI32, kBitcast };

constexpr float kBig = 3.0e38f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float as_f32(uint32_t w) {
  return __uint_as_float(w);
}

// Words of shared memory gather_accum_kernel stages: the table slice, then
// the block's index sets when there is more than one.
__host__ __device__ inline int gather_smem_words(const ProbeParams& p) {
  int nt = 0;
  if (p.form != kFma && p.form != kConvert) {
    if (p.axis == kLane) nt = p.ntab * p.bs * p.C;
    else if (p.axis == kSublane) nt = p.R * p.bl;
    else nt = p.ntab * p.R * p.C;
  }
  return nt + (p.unroll > 1 ? p.unroll * p.bs * p.bl : 0);
}

}  // namespace

extern __shared__ uint32_t probe_smem[];

template <int FORM, int AXIS, int DT, int NACC>
__global__ void __launch_bounds__(1024)
gather_accum_kernel(const uint32_t* __restrict__ tab,
                    const uint32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, ProbeParams p) {
  constexpr bool kGather = FORM != kFma && FORM != kConvert;
  const int tl = threadIdx.x, ts = threadIdx.y;
  const int nthr = blockDim.x * blockDim.y, tid = ts * blockDim.x + tl;
  const int s0 = blockIdx.y * p.bs, l0 = blockIdx.x * p.bl;
  const int s = s0 + ts, l = l0 + tl;

  uint32_t* st = probe_smem;
  int nt = 0;
  if constexpr (kGather && AXIS == kLane) {
    nt = p.ntab * p.bs * p.C;
    for (int k = tid; k < nt; k += nthr) {
      const int c = k % p.C, r = (k / p.C) % p.bs, t = k / (p.C * p.bs);
      st[k] = tab[((size_t)t * p.R + s0 + r) * p.C + c];
    }
  } else if constexpr (kGather && AXIS == kSublane) {
    nt = p.R * p.bl;
    for (int k = tid; k < nt; k += nthr)
      st[k] = tab[(size_t)(k / p.bl) * p.C + l0 + k % p.bl];
  } else if constexpr (kGather) {
    nt = p.ntab * p.R * p.C;
    for (int k = tid; k < nt; k += nthr) st[k] = tab[k];
  }
  uint32_t* si = st + nt;
  const bool staged = p.unroll > 1;
  if (staged) {
    const int ni = p.unroll * p.bs * p.bl;
    for (int k = tid; k < ni; k += nthr) {
      const int c = k % p.bl, r = (k / p.bl) % p.bs, u = k / (p.bl * p.bs);
      si[k] = idx[(size_t)u * p.idx_us + (size_t)(s0 + r) * p.idx_ss +
                  (size_t)(l0 + c) * p.idx_ls];
    }
  }
  __syncthreads();
  const uint32_t own =
      staged ? 0u : idx[(size_t)s * p.idx_ss + (size_t)l * p.idx_ls];
  // The multiply-add baseline's table value is its own element.
  const float t = FORM == kFma ? as_f32(tab[(size_t)s * p.C + l]) : 0.f;
  const uint32_t* row = st + ts * p.C;  // a lane gather's row, table 0
  const int tstride = p.bs * p.C, tmask = p.ntab - 1;
  const int iset = p.bs * p.bl, ioff = ts * p.bl + tl;

  using Acc = typename std::conditional<DT == kI32, uint32_t, float>::type;
  Acc acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0;

  for (int i = 0; i < p.trips; ++i) {
    for (int u = 0; u < p.unroll; u += NACC) {
#pragma unroll
      for (int k = 0; k < NACC; ++k) {
        const int uu = u + k;
        const uint32_t raw = staged ? si[uu * iset + ioff] : own;
        const int r = (int)raw;
        if constexpr (FORM == kFma) {
          acc[k] = fmaf(t, as_f32(raw), acc[k]);
        } else if constexpr (FORM == kConvert) {
          acc[k] = acc[k] + (float)((r + i) & p.mask);
        } else {
          uint32_t w;
          if constexpr (FORM == kClip2) {
            const int x = clampi(r + i, 0, 255);
            const uint32_t w0 = row[clampi(x, 0, 127)];
            const uint32_t w1 = row[128 + clampi(x - 128, 0, 127)];
            w = x < 128 ? w0 : w1;
          } else if constexpr (FORM == kAnd2) {
            const int x = (r + i) & 255, lo = x & 127;
            const uint32_t w0 = row[lo], w1 = row[128 + lo];
            w = x < 128 ? w0 : w1;
          } else {
            int ix = r;
            if constexpr (FORM == kMask) ix = r & p.mask;
            if constexpr (FORM == kAddMask) ix = (r + i) & p.mask;
            if constexpr (AXIS == kLane) w = row[(uu & tmask) * tstride + ix];
            else if constexpr (AXIS == kSublane) w = st[ix * p.bl + tl];
            else w = st[ix];
          }
          if constexpr (DT == kF32) acc[k] = acc[k] + as_f32(w);
          if constexpr (DT == kU32) acc[k] = acc[k] + (float)w;
          if constexpr (DT == kI32) acc[k] = acc[k] + w;
          if constexpr (DT == kBitcast)
            acc[k] = acc[k] + (float)(w & 0xFFFFu);
        }
      }
    }
  }
  Acc r = acc[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) r = r + acc[k];
  out += (size_t)blockIdx.z * p.S * p.L;
  if constexpr (DT == kI32) out[(size_t)s * p.L + l] = r;
  else out[(size_t)s * p.L + l] = __float_as_uint(r);
}

// out[s, l] = sum over trips and sets u of t[s, (l - sh[u]) mod C]; a block
// covers bs rows x bl pixels and stages its rows and the shifts.
__global__ void __launch_bounds__(1024)
roll_accum_kernel(const float* __restrict__ tab, const int* __restrict__ sh,
                  float* __restrict__ out, ProbeParams p) {
  const int tl = threadIdx.x, ts = threadIdx.y;
  const int nthr = blockDim.x * blockDim.y, tid = ts * blockDim.x + tl;
  const int s0 = blockIdx.y * p.bs, l = blockIdx.x * p.bl + tl;
  float* st = (float*)probe_smem;
  int* ssh = (int*)(probe_smem + p.bs * p.C);
  for (int k = tid; k < p.bs * p.C; k += nthr)
    st[k] = tab[(size_t)s0 * p.C + k];
  for (int k = tid; k < p.unroll; k += nthr) ssh[k] = sh[k];
  __syncthreads();
  const float* row = st + ts * p.C;
  const int cmask = p.C - 1;
  float acc = 0.f;
  for (int i = 0; i < p.trips; ++i)
    for (int u = 0; u < p.unroll; ++u) acc = acc + row[(l - ssh[u]) & cmask];
  out[((size_t)blockIdx.z * p.S + s0 + ts) * p.L + l] = acc;
}

// acc[q, w] += sum over cells c of onehot(c == (idx[q] + i) mod R) *
// tab[c, w]. A warp per output row q, lane j sweeps cells j, j + 32, ...
// (the table is staged transposed, [w][c], so the 32 lanes hit 32 banks);
// the lanes' partial sums meet in shared memory and lane w < W adds them in
// lane order. With a one-hot row every sum is exact, whatever its order.
__global__ void __launch_bounds__(256)
onehot_dot_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  float* __restrict__ out, ProbeParams p) {
  const int lane = threadIdx.x, warp = threadIdx.y, W = p.L, R = p.R;
  const int nthr = blockDim.x * blockDim.y, tid = warp * 32 + lane;
  const int q = blockIdx.x * blockDim.y + warp;
  float* st = (float*)probe_smem;             // [W][R]
  float* red = st + W * R;                    // [warps][W][32]
  for (int k = tid; k < W * R; k += nthr)
    st[(k % W) * R + k / W] = tab[k];
  __syncthreads();
  const int base = idx[q];
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float* myred = red + warp * W * 32;
  for (int i = 0; i < p.trips; ++i) {
    const int ix = (base + i) % R;
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < R; c += 32) {
      const float oh = c == ix ? 1.f : 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w)
        if (w < W) part[w] = fmaf(oh, st[w * R + c], part[w]);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w)
      if (w < W) myred[w * 32 + lane] = part[w];
    __syncthreads();
    if (lane < W) {
      float got = 0.f;
      for (int j = 0; j < 32; ++j) got = got + myred[lane * 32 + j];
#pragma unroll
      for (int w = 0; w < 8; ++w)
        if (w == lane) acc[w] = acc[w] + got;
    }
    __syncthreads();
  }
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (w == lane && w < W) out[(size_t)q * W + w] = acc[w];
}

// out (C, R) = x (R, C) transposed; one block.
__global__ void __launch_bounds__(256)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                 ProbeParams p) {
  for (int k = threadIdx.x; k < p.R * p.C; k += blockDim.x)
    out[(size_t)(k % p.C) * p.R + k / p.C] = x[k];
}

// Block y, thread l: per trip q = qx[0, l] + 0.001f * t, f[c] = curve[y, c] -
// q, hit[c] = f[c] * f[(c + 1) mod C] <= 0 and zc[y, c] < BIG, key = hit ?
// zc : BIG; (m1, o1) the least key and its lowest column, (m2, o2) the least
// of the rest; no hit gives column 0 and BIG, as the probe's masked minima
// do. out rows 4y .. 4y + 3 sum o1, m1, o2, m2 over the trips.
__global__ void __launch_bounds__(1024)
march_top2_kernel(const float* __restrict__ curve,
                  const float* __restrict__ zc, const float* __restrict__ qx,
                  float* __restrict__ out, ProbeParams p) {
  const int y = blockIdx.x, l = threadIdx.x, C = p.C;
  float* sc = (float*)probe_smem;
  float* sz = sc + C;
  for (int k = l; k < C; k += blockDim.x) {
    sc[k] = curve[(size_t)y * C + k];
    sz[k] = zc[(size_t)y * C + k];
  }
  __syncthreads();
  const float q0 = qx[l];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int t = 0; t < p.trips; ++t) {
    const float q = q0 + 0.001f * (float)t;
    const float f0 = sc[0] - q;
    float prev = f0, m1 = kBig, m2 = kBig;
    int o1 = -1, o2 = -1;
    for (int c = 0; c < C; ++c) {
      const float next = c + 1 < C ? sc[c + 1] - q : f0;
      const float z = sz[c];
      const float key = (prev * next <= 0.f && z < kBig) ? z : kBig;
      if (key < m1) {
        m2 = m1;
        o2 = o1;
        m1 = key;
        o1 = c;
      } else if (key < m2) {
        m2 = key;
        o2 = c;
      }
      prev = next;
    }
    a0 = a0 + (float)(o1 < 0 ? 0 : o1);
    a1 = a1 + m1;
    a2 = a2 + (float)(o2 < 0 ? 0 : o2);
    a3 = a3 + m2;
  }
  const size_t L = p.L;
  out += (size_t)blockIdx.z * 4 * p.S * L;
  out[(4 * y + 0) * L + l] = a0;
  out[(4 * y + 1) * L + l] = a1;
  out[(4 * y + 2) * L + l] = a2;
  out[(4 * y + 3) * L + l] = a3;
}

namespace {

using GatherFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                          ProbeParams);

// The instances the registered cases use.
GatherFn pick_gather(const ProbeParams& p) {
#define PROBE_PICK(F, A, D, N)                                         \
  if (p.form == F && p.axis == A && p.dtype == D && p.naccs == N)      \
    return gather_accum_kernel<F, A, D, N>;
  PROBE_PICK(kStatic, kLane, kF32, 1)
  PROBE_PICK(kStatic, kLane, kU32, 1)
  PROBE_PICK(kMask, kLane, kF32, 1)
  PROBE_PICK(kMask, kLane, kI32, 1)
  PROBE_PICK(kMask, kLane, kBitcast, 1)
  PROBE_PICK(kAddMask, kLane, kF32, 1)
  PROBE_PICK(kAddMask, kLane, kF32, 4)
  PROBE_PICK(kAddMask, kSublane, kF32, 1)
  PROBE_PICK(kAddMask, kFlat, kF32, 1)
  PROBE_PICK(kClip2, kLane, kF32, 1)
  PROBE_PICK(kAnd2, kLane, kF32, 1)
  PROBE_PICK(kFma, kLane, kF32, 1)
  PROBE_PICK(kConvert, kLane, kF32, 4)
#undef PROBE_PICK
  return nullptr;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_tiles(const ProbeParams* p) {
  return p->bs <= 0 || p->bl <= 0 || p->bs * p->bl > 1024 ||
         p->S % p->bs != 0 || p->L % p->bl != 0 || p->trips < 0 ||
         p->copies < 1 || p->copies > 65535;
}

}  // namespace

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int probe_gather_accum(const void* tab, const void* idx, void* out,
                       const ProbeParams* p, void* stream) {
  const GatherFn fn = pick_gather(*p);
  if (fn == nullptr || bad_tiles(p) || p->unroll % p->naccs != 0 ||
      (p->ntab & (p->ntab - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)gather_smem_words(*p) * 4;
  if (const int e = set_smem((const void*)fn, smem)) return e;
  const dim3 grid(p->L / p->bl, p->S / p->bs, p->copies);
  const dim3 block(p->bl, p->bs);
  fn<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, (const uint32_t*)idx, (uint32_t*)out, *p);
  return (int)cudaGetLastError();
}

int probe_roll_accum(const void* tab, const void* sh, void* out,
                     const ProbeParams* p, void* stream) {
  if (bad_tiles(p) || (p->C & (p->C - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)p->bs * p->C + p->unroll) * 4;
  if (const int e = set_smem((const void*)roll_accum_kernel, smem)) return e;
  const dim3 grid(p->L / p->bl, p->S / p->bs, p->copies);
  const dim3 block(p->bl, p->bs);
  roll_accum_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)sh, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_onehot_dot(const void* tab, const void* idx, void* out,
                     const ProbeParams* p, void* stream) {
  // p->S rows, p->L (<= 8) values a row, p->R cells; 8 rows a block.
  if (p->L <= 0 || p->L > 8 || p->S % 8 != 0 || p->R <= 0 || p->trips < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)p->L * p->R + 8 * p->L * 32) * 4;
  if (const int e = set_smem((const void*)onehot_dot_kernel, smem)) return e;
  const dim3 grid(p->S / 8), block(32, 8);
  onehot_dot_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_transpose(const void* x, void* out, const ProbeParams* p,
                    void* stream) {
  if (p->R <= 0 || p->C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(1), block(256);
  transpose_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_march_top2(const void* curve, const void* zc, const void* qx,
                     void* out, const ProbeParams* p, void* stream) {
  // p->S rows y, p->C columns, p->L pixels (one thread each).
  if (p->S <= 0 || p->C <= 0 || p->L <= 0 || p->L > 1024 || p->trips < 0 ||
      p->copies < 1 || p->copies > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * p->C * 4;
  if (const int e = set_smem((const void*)march_top2_kernel, smem)) return e;
  const dim3 grid(p->S, 1, p->copies), block(p->L);
  march_top2_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)curve, (const float*)zc, (const float*)qx, (float*)out,
      *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
