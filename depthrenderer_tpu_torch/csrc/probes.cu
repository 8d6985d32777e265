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
//                 index sets, a value gathered from a table staged in shared
//                 memory (the card's counterpart of VMEM). Index forms:
//                 static, & mask, (+ trip) & mask (the probes' (idx + i) % n
//                 for a power-of-two n and idx + i >= 0, where the two are
//                 equal), the two-subtable clip and the &255 two-subtable
//                 select; along rows (lane), along columns (sublane) or over
//                 the flat table; f32, u32 (cast to f32), i32 (wrapping sum)
//                 or the low 16 bits of the f32 bits; 1 or 8 tables, 1 or 4
//                 rotating accumulators; the baselines without a gather
//                 (multiply-add, index convert).
//   roll_accum    gather_probe5 build_roll: out[s, l] += t[s, (l - sh) mod C],
//                 jnp.roll's convention, with a per-set traced shift.
//   onehot_dot    gather_probe build_onehot_mxu: the one-hot contraction done
//                 densely on the tensor cores, every (row, cell, value)
//                 multiply-add over every cell of the table each trip (not a
//                 shortcut to a gather: no k-block is skipped).
//   transpose     scan_probe_march P1, through shared-memory tiles.
//   march_top2    scan_probe_march P2: per row y and pixel l the dense sign
//                 test over the row's C crossing columns and the top 2 keys
//                 with their lowest column index, summed over the trips.
//
// What bounds them on an H100: a gather or the roll is one shared-memory
// word per lookup per thread, 32 words a clock per SM when the 32 lanes of a
// warp hit 32 banks; the baselines are bound by FP32 at 128 multiply-adds a
// clock per SM, onehot_dot by the tensor cores' bf16 rate (2,048 dense
// multiply-adds a clock per SM) on its three parts, the march's sweep by its
// two FP32 operations a column (and, in practice, by the compares and
// selects around them), the transpose by device memory.
//
// gather_accum's design: the block's slice of the table is staged in shared
// memory, each word as 2^lg_stripe copies side by side (ProbeParams), so
// that lane j of a warp reads copy j % 2^lg_stripe in bank j: with 32
// copies (a lane gather's row of up to 512 words, 64 KB) no index can
// conflict; a sublane gather's staged [rows][32 columns] is the same
// layout, the copies being its 32 columns. Where 32 copies do not fit in 64
// KB (8 tables: 16 copies; the flat table: one) the conflicts the indices
// give are counted by the host (probes.wavefronts). A word's byte offset is
// ((x << lg_stripe) | copy) * 4, so a (idx + i) & mask index is one add and
// one AND-OR a lookup, a static or & mask index none: each thread's index
// sets sit in registers as offsets, loaded once. The trip loop runs in
// stages of 16 lookups (16 trips of one set, 2 trips of 8, or 16 of a
// trip's 32 or 64 sets): a stage's 16 shared loads are issued before its
// adds, and each accumulator's adds stay one chain in the probe's order.
// The loads are volatile: a static index reads the same words every trip,
// and the load must happen every trip. An int-to-float conversion (u32,
// bitcast, the convert baseline) is one instruction, I2FP or I2F.U16,
// neither of which binds at the shared-memory rate.
//
// march_top2's design: each thread sweeps its pixel for 4 trips at once (4
// independent chains), the row's curve and depth read 4 columns at a time as
// float4 broadcasts (curve padded by its first 4 columns: column C - 1
// pairs with column 0), and the top 2 kept with predicates and selects, no
// branch per column. The compares and selects run on the ALU pipe, at half
// the FP32 rate: nine a column would bind the sweep at ~9x its FP32 bound.
// So a group of 4 columns computes its 16 products first (a subtract, a
// multiply and one accumulated compare each) and runs the selects only when
// a warp vote finds a product <= 0 in it: a pixel's row crosses it in few
// of the 64 groups.
//
// roll_accum's design: a thread per output (s, l), a block one row of 128
// pixels (4 warps; the probe's 8 rows on 8 SMs). Set u's word for pixel l is
// t[s, (l - sh[u]) mod C] on every trip, so each thread computes its 64 byte
// offsets once, into registers: a lookup is one shared-memory load
// (volatile: the same word is read every trip) and the add. A trip's 64
// lookups run in stages of 16, each stage's loads issued before the
// previous stage's adds, the adds one chain in (trip, set) order. A warp's
// 32 lanes read 32 neighbouring columns (mod C): 32 banks. The one chain an
// output lets a warp add once in 4 clocks, so 4 warps an SM (one a
// scheduler) ask for 32 words a clock, the shared-memory rate; with copies
// an SM holds more warps than that needs.
//
// onehot_dot's design: trip i's product onehot (P x R) @ tab (R x W, W <=
// 8) is taken by mma.sync m16n8k16, bf16 in and f32 accumulate
// (mma_bf16_16816 below). A (16 x 16) is the one-hot: its rows are the
// block's 8 output rows at trip i, then the same rows at trip i + 1; B (16
// x 8) is a part of the table, its 8 columns the W values of a cell. One
// instruction then does 16 x 8 x 16 needed multiply-adds, and a trip
// exactly the 3 x P x R x W of the table's three parts. The tensor cores
// multiply bf16, so tab is split once a launch into three bf16 parts (hi,
// mid, lo), each with its own f32 accumulator, zeroed every round: an
// accumulator gathers one exact product (1.0 times a part) and exact zeros,
// whatever order or width the tensor core adds in, and (lo + mid) + hi on
// the CUDA cores gives x back exactly.
//
// The split (split_bf16x3; depthrenderer_tpu_torch/probes/gather.py
// split_bf16x3 is the same formula): hi is x rounded toward zero to bf16
// (x's high 16 bits), r = x - hi (exact: same sign, |hi| <= |x| < 2|hi|),
// mid is r toward zero and lo = r - mid (exact, likewise). x's 24
// significant bits sit at 2^e .. 2^(e-23); hi holds 2^e .. 2^(e-7) and r
// the 16 bits below; mid holds r's top 8 from its leading bit 2^e1, e1 <= e
// - 8, so lo holds 2^(e1-8) .. 2^(e-23), at most e1 - e + 16 <= 8 bits: lo
// is a bf16 exactly, and hi + mid + lo = x. The parts are also kept normal
// bf16 (not subnormals, whose handling by the tensor cores is not what this
// probe asks): where |hi| >= 2^-100, each part's lowest bit is >= 2^(e-23)
// >= 2^-123; below, r is scaled by 2^64 before mid and lo are taken (exact;
// then >= 2^-85), and the join scales it back: x = (lo + mid) * (|hi| <
// 2^-100 ? 2^-64 : 1) + hi, every step exact. So the split holds, in
// normal parts, for every finite normal f32 and +-0. An f32 subnormal is
// split exactly too, but its hi is a bf16 subnormal, which the tensor core
// must pass through (the card test's subnormal table holds it to that).
//
// The K of R = 1,536 cells is split over the block's 8 warps, 12 k-steps of
// 16 cells each, so a warp keeps its B fragments of the three parts in 72
// registers for the whole launch. It rebuilds A from registers every k-step:
// for each of its two rows it knows, from idx and the trip, the k-step of the
// hot cell and the bf16 1.0's place in the fragment (d = ix - k0 - column),
// and a compare and two selects set the row's A registers to it or to 0. A
// round is two A tiles (four trips): 6 independent accumulator chains a
// warp. A warp's (lo + mid) + hi of each (trip, row, value) is its share of
// the sum over cells, x or 0; the shares meet in shared memory (double
// buffered: one barrier a round), and lane w < W of warp r sums the 8
// warps' shares pairwise (x and exact zeros: any order is exact) and adds
// each trip's x to output (p0 + r, w), in trip order, as the twin does. 8
// output rows a block: the probe's 1,024 rows take 128 SMs.
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
// gather_accum, roll_accum, onehot_dot and march_top2 compute `copies`
// identical outputs, one per blockIdx.z, to fill more of the card than the
// probe's one tile does. lg_stripe: gather_accum's staged word stride, log2
// (see above).
struct ProbeParams {
  int form, axis, dtype, naccs;
  int S, L, ntab, R, C, unroll;
  int idx_us, idx_ss, idx_ls;
  int mask, trips, bs, bl, copies;
  int lg_stripe;
};

namespace {

enum Form { kStatic, kMask, kAddMask, kClip2, kAnd2, kFma, kConvert };
enum Axis { kLane, kSublane, kFlat };
enum Dtype { kF32, kU32, kI32, kBitcast };

constexpr float kBig = 3.0e38f;
// gather_accum's and roll_accum's lookups a stage (see above).
constexpr int kStage = 16;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float as_f32(uint32_t w) {
  return __uint_as_float(w);
}

// Words of the table gather_accum_kernel stages: the block's slice (a lane
// gather's row of every table, a sublane gather's bl columns of every row,
// the flat table), each word 2^lg_stripe times.
__host__ __device__ inline int gather_smem_words(const ProbeParams& p) {
  if (p.form == kFma || p.form == kConvert) return 0;
  if (p.axis == kLane) return (p.ntab * p.C) << p.lg_stripe;
  if (p.axis == kSublane) return p.R * p.bl;
  return p.ntab * p.R * p.C;
}

}  // namespace

extern __shared__ __align__(16) uint32_t probe_smem[];

namespace {

// The word at byte offset b of the staged table, read every time it is
// asked for (see above).
__device__ __forceinline__ uint32_t lds(uint32_t b) {
  return *(const volatile uint32_t*)((const volatile char*)probe_smem + b);
}

// A thread's view of the staged table and of its index sets.
struct GatherCtx {
  uint32_t copy;    // its copy's byte offset in a staged word's stripe
  uint32_t mask_s;  // the index mask as a byte offset
  int sh;           // log2 of a staged word's stride in bytes
  int mask;
  float t;          // the multiply-add baseline's table value
};

// Set u's word at trip i (sets' values a: a byte offset for the static and
// & mask forms, idx << sh for (+ trip) & mask and &255, idx for the clip,
// the value for the baselines). The baselines return what their add takes:
// the set's value, or (idx + i) & mask.
template <int FORM>
__device__ __forceinline__ uint32_t fetch(uint32_t a, int i,
                                          const GatherCtx& g) {
  if constexpr (FORM == kStatic || FORM == kMask) {
    return lds(a);
  } else if constexpr (FORM == kAddMask) {
    return lds(((a + ((uint32_t)i << g.sh)) & g.mask_s) | g.copy);
  } else if constexpr (FORM == kClip2) {
    const int x = clampi((int)a + i, 0, 255);
    const uint32_t w0 = lds(((uint32_t)clampi(x, 0, 127) << g.sh) | g.copy);
    const uint32_t w1 =
        lds(((uint32_t)(128 + clampi(x - 128, 0, 127)) << g.sh) | g.copy);
    return x < 128 ? w0 : w1;
  } else if constexpr (FORM == kAnd2) {
    const uint32_t v = a + ((uint32_t)i << g.sh);
    const uint32_t b = (v & (127u << g.sh)) | g.copy;
    const uint32_t w0 = lds(b), w1 = lds(b + (128u << g.sh));
    return (v & (128u << g.sh)) == 0 ? w0 : w1;
  } else if constexpr (FORM == kConvert) {
    return (uint32_t)(((int)a + i) & g.mask);
  } else {
    return a;
  }
}

template <int DT>
using AccT = typename std::conditional<DT == kI32, uint32_t, float>::type;

// acc plus what word w adds.
template <int FORM, int DT>
__device__ __forceinline__ AccT<DT> add_word(AccT<DT> acc, uint32_t w,
                                             const GatherCtx& g) {
  if constexpr (FORM == kFma) return fmaf(g.t, as_f32(w), acc);
  else if constexpr (FORM == kConvert) return acc + (float)(int)w;
  else if constexpr (DT == kF32) return acc + as_f32(w);
  else if constexpr (DT == kU32) return acc + (float)w;
  else if constexpr (DT == kI32) return acc + w;
  else return acc + (float)(w & 0xFFFFu);
}

// Loop iteration `it`, stage `ch`: lookup j is trip it * TU + j / U, set
// j % U (U < kStage), or trip it, set ch * kStage + j.
template <int FORM, int U, int TU>
__device__ __forceinline__ void fetch_stage(uint32_t (&v)[kStage],
                                            const uint32_t (&a)[U], int it,
                                            int ch, const GatherCtx& g) {
#pragma unroll
  for (int j = 0; j < kStage; ++j) {
    if constexpr (U < kStage)
      v[j] = fetch<FORM>(a[j % U], it * TU + j / U, g);
    else
      v[j] = fetch<FORM>(a[ch * kStage + j], it, g);
  }
}

template <int FORM, int DT, int NACC, int U>
__device__ __forceinline__ void add_stage(AccT<DT> (&acc)[NACC],
                                          const uint32_t (&v)[kStage], int ch,
                                          const GatherCtx& g) {
#pragma unroll
  for (int j = 0; j < kStage; ++j) {
    const int k = (U < kStage ? j % U : ch * kStage + j) % NACC;
    acc[k] = add_word<FORM, DT>(acc[k], v[j], g);
  }
}

}  // namespace

template <int FORM, int AXIS, int DT, int NACC, int U>
__global__ void __launch_bounds__(256)
gather_accum_kernel(const uint32_t* __restrict__ tab,
                    const uint32_t* __restrict__ idx,
                    uint32_t* __restrict__ out, ProbeParams p) {
  constexpr bool kGather = FORM != kFma && FORM != kConvert;
  static_assert(U < kStage ? kStage % U == 0 : U % kStage == 0,
                "a stage holds whole trips or whole sixteenths of a trip");
  constexpr int TU = U < kStage ? kStage / U : 1;  // trips an iteration
  constexpr int NCH = U < kStage ? 1 : U / kStage;  // stages an iteration
  const int tl = threadIdx.x, ts = threadIdx.y;
  const int nthr = blockDim.x * blockDim.y, tid = ts * blockDim.x + tl;
  const int s0 = blockIdx.y * p.bs, l0 = blockIdx.x * p.bl;
  const int s = s0 + ts, l = l0 + tl;
  // The forms that offset every lookup take the stripe as a constant (32
  // copies; one for the flat table), so that their shifts are immediates.
  constexpr bool kPerLookup = FORM == kAddMask || FORM == kClip2 ||
                              FORM == kAnd2;
  const int lg = kPerLookup ? (AXIS == kFlat ? 0 : 5) : p.lg_stripe;
  const int rep = 1 << lg;

  if constexpr (kGather && AXIS == kLane) {
    // Row s0 of every table, word (t, w) at ((t * C + w) << lg) + copy.
    const int nw = p.ntab * p.C;
    if (rep >= 4) {
      uint4* st4 = (uint4*)probe_smem;
      for (int k = tid; k < (nw << lg) / 4; k += nthr) {
        const int tw = (4 * k) >> lg, t = tw / p.C, w = tw % p.C;
        const uint32_t v = tab[((size_t)t * p.R + s0) * p.C + w];
        st4[k] = make_uint4(v, v, v, v);
      }
    } else {
      for (int k = tid; k < (nw << lg); k += nthr) {
        const int tw = k >> lg, t = tw / p.C, w = tw % p.C;
        probe_smem[k] = tab[((size_t)t * p.R + s0) * p.C + w];
      }
    }
  } else if constexpr (kGather && AXIS == kSublane) {
    // Every row of the block's bl columns, word (r, c) at r * bl + c.
    for (int k = tid; k < p.R * p.bl; k += nthr)
      probe_smem[k] = tab[(size_t)(k / p.bl) * p.C + l0 + k % p.bl];
  } else if constexpr (kGather) {
    for (int k = tid; k < p.ntab * p.R * p.C; k += nthr)
      probe_smem[k] = tab[k];
  }

  GatherCtx g;
  g.sh = lg + 2;
  g.copy = (uint32_t)(tl & (rep - 1)) << 2;
  g.mask = p.mask;
  g.mask_s = (uint32_t)p.mask << g.sh;
  g.t = FORM == kFma ? as_f32(tab[(size_t)s * p.C + l]) : 0.f;
  // The sets as fetch() takes them, in registers for the whole loop.
  uint32_t a[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint32_t raw = idx[(size_t)u * p.idx_us + (size_t)s * p.idx_ss +
                             (size_t)l * p.idx_ls];
    const uint32_t tb = (uint32_t)((u & (p.ntab - 1)) * p.C) << g.sh;
    if constexpr (FORM == kStatic)
      a[u] = tb + ((raw << g.sh) | g.copy);
    else if constexpr (FORM == kMask)
      a[u] = tb + (((raw & (uint32_t)p.mask) << g.sh) | g.copy);
    else if constexpr (FORM == kAddMask || FORM == kAnd2)
      a[u] = raw << g.sh;
    else
      a[u] = raw;
  }
  __syncthreads();

  AccT<DT> acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0;
  // Whole iterations, a stage's loads issued before its adds (the compiler
  // overlaps a stage's adds with the next stage's loads). The baselines
  // load nothing: they run the plain loop below.
  const int nit = kGather ? p.trips / TU : 0;
  for (int it = 0; it < nit; ++it) {
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      uint32_t v[kStage];
      fetch_stage<FORM, U, TU>(v, a, it, ch, g);
      add_stage<FORM, DT, NACC, U>(acc, v, ch, g);
    }
  }
  // The trips left over (U < kStage only), or all of a baseline's.
  for (int i = nit * TU; i < p.trips; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint32_t w = fetch<FORM>(a[u], i, g);
      acc[u % NACC] = add_word<FORM, DT>(acc[u % NACC], w, g);
    }
  }
  AccT<DT> r = acc[0];
#pragma unroll
  for (int k = 1; k < NACC; ++k) r = r + acc[k];
  out += (size_t)blockIdx.z * p.S * p.L;
  if constexpr (DT == kI32) out[(size_t)s * p.L + l] = r;
  else out[(size_t)s * p.L + l] = __float_as_uint(r);
}

namespace {

// roll_accum's stage ch: the words of sets ch * kStage .. + kStage - 1.
template <int U>
__device__ __forceinline__ void roll_stage(float (&v)[kStage],
                                           const uint32_t (&off)[U], int ch) {
#pragma unroll
  for (int j = 0; j < kStage; ++j) v[j] = as_f32(lds(off[ch * kStage + j]));
}

}  // namespace

// out[s, l] = sum over trips and sets u of t[s, (l - sh[u]) mod C] (see
// above): a block covers bs rows x bl pixels and stages its rows; U sets.
template <int U>
__global__ void __launch_bounds__(128)
roll_accum_kernel(const float* __restrict__ tab, const int* __restrict__ sh,
                  float* __restrict__ out, ProbeParams p) {
  static_assert(U % (2 * kStage) == 0, "stages of 16 sets, in pairs");
  const int tl = threadIdx.x, ts = threadIdx.y;
  const int nthr = blockDim.x * blockDim.y, tid = ts * blockDim.x + tl;
  const int s0 = blockIdx.y * p.bs, l = blockIdx.x * p.bl + tl;
  float* st = (float*)probe_smem;
  for (int k = tid; k < p.bs * p.C; k += nthr)
    st[k] = tab[(size_t)s0 * p.C + k];
  // The thread's word of each set, as a byte offset, for every trip.
  const uint32_t row = (uint32_t)(ts * p.C) << 2, cmask = p.C - 1;
  uint32_t off[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    off[u] = row + (((uint32_t)(l - sh[u]) & cmask) << 2);
  __syncthreads();
  // Stage ch + 1's loads (the next trip's first after the last) are issued
  // before stage ch's adds.
  constexpr int NS = U / kStage;
  float v0[kStage], v1[kStage];
  roll_stage<U>(v0, off, 0);
  float acc = 0.f;
  for (int i = 0; i < p.trips; ++i) {
#pragma unroll
    for (int ch = 0; ch < NS; ch += 2) {
      roll_stage<U>(v1, off, ch + 1);
#pragma unroll
      for (int j = 0; j < kStage; ++j) acc = acc + v0[j];
      roll_stage<U>(v0, off, (ch + 2) % NS);
#pragma unroll
      for (int j = 0; j < kStage; ++j) acc = acc + v1[j];
    }
  }
  out[((size_t)blockIdx.z * p.S + s0 + ts) * p.L + l] = acc;
}

// The tensor-core instruction onehot_dot runs: d (16 x 8 f32) += a (16 x
// 16 bf16, row-major) x b (16 x 8 bf16, column-major), one warp together
// (PTX mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32). With g = lane
// / 4 and t = lane % 4, a lane holds a[0] = A[g][2t, 2t + 1], a[1] = A[g +
// 8][2t, 2t + 1], a[2] = A[g][2t + 8, 2t + 9], a[3] = A[g + 8][2t + 8, 2t +
// 9], b[0] = B[2t, 2t + 1][g], b[1] = B[2t + 8, 2t + 9][g] (the lower index
// in the low 16 bits), d = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g +
// 8][2t + 1]. The host build of this file for the CPU tests brings its own.
#ifdef __CUDACC__
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

namespace {

// onehot_dot's shape (see above): 8 warps a block, each 12 k-steps of 16
// cells (R = 1,536), 8 output rows a block, two A tiles (four trips) a
// round.
constexpr int kOhWarps = 8, kOhSteps = 12, kOhRows = 8, kOhTiles = 2;
constexpr int kOhCells = kOhWarps * kOhSteps * 16;
constexpr int kOhTrips = 2 * kOhTiles;
// Below kOhTiny, mid and lo are taken of r * 2^64 (see above).
constexpr float kOhTiny = 0x1p-100f, kOhUp = 0x1p64f, kOhDown = 0x1p-64f;
// The bf16 word of 1.0.
constexpr uint32_t kBf16One = 0x3F80u;

// x's three bf16 parts, hi, mid and lo (see above).
__device__ __forceinline__ void split_bf16x3(float x, uint32_t (&part)[3]) {
  const uint32_t xb = __float_as_uint(x);
  const float hi = __uint_as_float(xb & 0xFFFF0000u);
  float r = x - hi;
  if (fabsf(hi) < kOhTiny) r = r * kOhUp;
  const uint32_t rb = __float_as_uint(r);
  part[0] = xb >> 16;
  part[1] = rb >> 16;
  part[2] = __float_as_uint(r - __uint_as_float(rb & 0xFFFF0000u)) >> 16;
}

// x from its parts (each as the f32 the tensor core returns).
__device__ __forceinline__ float join_bf16x3(float hi, float mid, float lo) {
  const float r = lo + mid;
  return (fabsf(hi) < kOhTiny ? r * kOhDown : r) + hi;
}

}  // namespace

// acc[p, w] += sum over cells c of onehot(c == (idx[p] + i) mod R) *
// tab[c, w], over the trips i (see above): block (32, 8), 8 rows p from
// p0, copy blockIdx.z.
__global__ void __launch_bounds__(32 * kOhWarps)
onehot_dot_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                  float* __restrict__ out, ProbeParams p) {
  static_assert(kOhWarps == kOhRows, "warp r's lanes own output row p0 + r");
  const int lane = threadIdx.x, warp = threadIdx.y, W = p.L;
  const int g = lane >> 2, t = lane & 3, p0 = blockIdx.x * kOhRows;
  // This warp's B fragments of the three parts, k-step kk: cells c0 + kk *
  // 16 + {2t, 2t + 1} and {2t + 8, 2t + 9}, value g.
  const int c0 = warp * kOhSteps * 16 + 2 * t;
  uint32_t b[kOhSteps][3][2];
#pragma unroll
  for (int kk = 0; kk < kOhSteps; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + kk * 16 + 8 * h;
      uint32_t lo[3], hi[3];
      split_bf16x3(g < W ? tab[(size_t)c * W + g] : 0.f, lo);
      split_bf16x3(g < W ? tab[(size_t)(c + 1) * W + g] : 0.f, hi);
#pragma unroll
      for (int q = 0; q < 3; ++q) b[kk][q][h] = lo[q] | hi[q] << 16;
    }
  }
  // Row p0 + g's cell at the round's first trip, in [0, R).
  int ix = idx[p0 + g] % kOhCells;
  if (ix < 0) ix += kOhCells;
  float* red = (float*)probe_smem;  // [2][warp][trip][row][8]
  constexpr int kRed = kOhWarps * kOhTrips * kOhRows * 8;
  float acc = 0.f;
  for (int i0 = 0, buf = 0; i0 < p.trips; i0 += kOhTrips, buf ^= 1) {
    // Per tile j and row half r (trip i0 + 2j + r): the k-step of the hot
    // cell, counted from this warp's first (-1 past the last trip), and its
    // 1.0 in a[r] (columns < 8) or a[r + 2] (columns >= 8).
    int kb[kOhTiles][2];
    uint32_t fl[kOhTiles][2], fh[kOhTiles][2];
#pragma unroll
    for (int j = 0; j < kOhTiles; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int x = ix + 2 * j + r;
        if (x >= kOhCells) x -= kOhCells;
        const int col = x & 15;
        const uint32_t one =
            (col & 7) >> 1 == t ? kBf16One << ((col & 1) << 4) : 0u;
        kb[j][r] = i0 + 2 * j + r < p.trips ? (x >> 4) - warp * kOhSteps : -1;
        fl[j][r] = col < 8 ? one : 0u;
        fh[j][r] = col < 8 ? 0u : one;
      }
    }
    ix += kOhTrips;
    if (ix >= kOhCells) ix -= kOhCells;
    float d[kOhTiles][3][4];
#pragma unroll
    for (int j = 0; j < kOhTiles; ++j)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[j][q][e] = 0.f;
    // Every k-step, every tile, every part: the dense contraction.
#pragma unroll
    for (int kk = 0; kk < kOhSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < kOhTiles; ++j) {
        const bool h0 = kb[j][0] == kk, h1 = kb[j][1] == kk;
        const uint32_t a[4] = {h0 ? fl[j][0] : 0u, h1 ? fl[j][1] : 0u,
                               h0 ? fh[j][0] : 0u, h1 ? fh[j][1] : 0u};
#pragma unroll
        for (int q = 0; q < 3; ++q) mma_bf16_16816(d[j][q], a, b[kk][q]);
      }
    }
    // This warp's share of (trip 2j + e / 2, row g, value 2t + e % 2).
    float* mine = red + buf * kRed + warp * (kOhTrips * kOhRows * 8);
#pragma unroll
    for (int j = 0; j < kOhTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[((2 * j + (e >> 1)) * kOhRows + g) * 8 + 2 * t + (e & 1)] =
            join_bf16x3(d[j][0][e], d[j][1][e], d[j][2][e]);
    __syncthreads();
    if (lane < W) {
      // Each trip's 8 shares summed pairwise, then added in trip order.
      const float* all = red + buf * kRed + warp * 8 + lane;
      float x[kOhTrips];
#pragma unroll
      for (int tt = 0; tt < kOhTrips; ++tt) {
        float sum[kOhWarps];
#pragma unroll
        for (int v = 0; v < kOhWarps; ++v)
          sum[v] = all[(v * kOhTrips + tt) * kOhRows * 8];
#pragma unroll
        for (int h = kOhWarps / 2; h > 0; h /= 2)
#pragma unroll
          for (int v = 0; v < h; ++v) sum[v] = sum[v] + sum[v + h];
        x[tt] = sum[0];
      }
#pragma unroll
      for (int tt = 0; tt < kOhTrips; ++tt)
        if (i0 + tt < p.trips) acc = acc + x[tt];
    }
  }
  if (lane < W)
    out[((size_t)blockIdx.z * p.S + p0 + warp) * W + lane] = acc;
}

// out (C, R) = x (R, C) transposed, through 32 x 32 tiles in shared memory
// (a row of 33, so a column's 32 words fall in 32 banks): block (32, 8),
// one tile each; lane x reads column c0 + x of the tile's rows and writes
// column r0 + x of its output rows, so both sides are coalesced, and each
// thread's four rows are loaded before any is stored (one round trip to
// memory, not one per element).
constexpr int kTile = 32, kTileRows = 8;

__global__ void __launch_bounds__(kTile * kTileRows)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                 ProbeParams p) {
  float(*tile)[kTile + 1] = (float(*)[kTile + 1])probe_smem;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    const int r = r0 + ty + j, c = c0 + tx;
    if (r < p.R && c < p.C) tile[ty + j][tx] = x[(size_t)r * p.C + c];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTile; j += kTileRows) {
    const int c = c0 + ty + j, r = r0 + tx;
    if (c < p.C && r < p.R) out[(size_t)c * p.R + r] = tile[tx][ty + j];
  }
}

namespace {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *(const float4*)p;
}

// A float of the staged row, read where it is asked for (see march_trips).
__device__ __forceinline__ float ldsv(const float* p) {
  return *(const volatile float*)p;
}

// K trips t0 .. t0 + K - 1 of one pixel's sweep over a row staged as sc
// (the curve, padded by its first 4 columns) and sz (the depths), each trip
// its own chain; each trip's (o1, m1, o2, m2) is added to a0 .. a3 in trip
// order. hit = f[c] * f[c + 1] <= 0 in float32; a hit's key z takes first
// place if z < m1 and second if z < m2 (strict: an equal key keeps the lower
// column; z < m2 <= BIG also holds the probe's z < BIG); no hit leaves
// column 0 with BIG. A group of 4 columns first takes its products and one
// accumulated compare each; only where a lane of the warp has a product <=
// 0 (a vote) does it run the top-2 update, branchless, recomputing the
// group's products from a second, volatile read of the row: the compiler
// then has no per-column hit to compute ahead of the vote (it did, and kept
// the 16 bits in a register at 3 instructions each).
template <int K>
__device__ __forceinline__ void march_trips(const float* sc, const float* sz,
                                            int C, float q0, int t0,
                                            float (&a)[4]) {
  float q[K], prev[K], m1[K], m2[K];
  int o1[K], o2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    q[k] = q0 + 0.001f * (float)(t0 + k);
    prev[k] = sc[0] - q[k];
    m1[k] = m2[k] = kBig;
    o1[k] = o2[k] = 0;
  }
  float4 cur = ld4(sc);
  for (int c = 0; c < C; c += 4) {
    const float4 nxt = ld4(sc + c + 4);
    const float cv[4] = {cur.y, cur.z, cur.w, nxt.x};  // curve[c + 1 ..]
    float fc[K];  // f[c] of each chain
    bool none = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      fc[k] = prev[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = cv[j] - q[k];
        none = none & !(prev[k] * f <= 0.f);  // & not &&: no branch
        prev[k] = f;
      }
    }
    if (__any_sync(0xffffffffu, !none)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cn = ldsv(sc + c + j + 1), z = ldsv(sz + c + j);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float f = cn - q[k];
          const bool hit = fc[k] * f <= 0.f;
          const bool lt1 = hit & (z < m1[k]);
          const bool lt2 = hit & (z < m2[k]);
          m2[k] = lt1 ? m1[k] : (lt2 ? z : m2[k]);
          o2[k] = lt1 ? o1[k] : (lt2 ? c + j : o2[k]);
          m1[k] = lt1 ? z : m1[k];
          o1[k] = lt1 ? c + j : o1[k];
          fc[k] = f;
        }
      }
    }
    cur = nxt;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[0] = a[0] + (float)o1[k];
    a[1] = a[1] + m1[k];
    a[2] = a[2] + (float)o2[k];
    a[3] = a[3] + m2[k];
  }
}

}  // namespace

// Trips in chains of kMarchChains (then one at a time).
constexpr int kMarchChains = 4;

// Block y (of copy z), thread l: per trip q = qx[0, l] + 0.001f * t, f[c] =
// curve[y, c] - q, hit[c] = f[c] * f[(c + 1) mod C] <= 0 and zc[y, c] <
// BIG, key = hit ? zc : BIG; (m1, o1) the least key and its lowest column,
// (m2, o2) the least of the rest; no hit gives column 0 and BIG, as the
// probe's masked minima do. out rows 4y .. 4y + 3 sum o1, m1, o2, m2 over
// the trips.
__global__ void __launch_bounds__(1024)
march_top2_kernel(const float* __restrict__ curve,
                  const float* __restrict__ zc, const float* __restrict__ qx,
                  float* __restrict__ out, ProbeParams p) {
  const int y = blockIdx.x, l = threadIdx.x, C = p.C;
  float* sc = (float*)probe_smem;  // C + 4: the curve, then columns 0 .. 3
  float* sz = sc + C + 4;
  for (int k = l; k < C + 4; k += blockDim.x)
    sc[k] = curve[(size_t)y * C + (k < C ? k : k - C)];
  for (int k = l; k < C; k += blockDim.x) sz[k] = zc[(size_t)y * C + k];
  __syncthreads();
  const float q0 = qx[l];
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int t = 0;
  for (; t + kMarchChains <= p.trips; t += kMarchChains)
    march_trips<kMarchChains>(sc, sz, C, q0, t, a);
  for (; t < p.trips; ++t) march_trips<1>(sc, sz, C, q0, t, a);
  const size_t L = p.L;
  out += (size_t)blockIdx.z * 4 * p.S * L;
  out[(4 * y + 0) * L + l] = a[0];
  out[(4 * y + 1) * L + l] = a[1];
  out[(4 * y + 2) * L + l] = a[2];
  out[(4 * y + 3) * L + l] = a[3];
}

namespace {

using GatherFn = void (*)(const uint32_t*, const uint32_t*, uint32_t*,
                          ProbeParams);

// The instances the registered cases use: (form, axis, dtype, accumulators,
// index sets).
GatherFn pick_gather(const ProbeParams& p) {
#define PROBE_PICK(F, A, D, N, U)                                       \
  if (p.form == F && p.axis == A && p.dtype == D && p.naccs == N &&     \
      p.unroll == U)                                                    \
    return gather_accum_kernel<F, A, D, N, U>;
  PROBE_PICK(kAddMask, kLane, kF32, 1, 1)
  PROBE_PICK(kAddMask, kSublane, kF32, 1, 1)
  PROBE_PICK(kAddMask, kFlat, kF32, 1, 1)
  PROBE_PICK(kClip2, kLane, kF32, 1, 1)
  PROBE_PICK(kAnd2, kLane, kF32, 1, 1)
  PROBE_PICK(kStatic, kLane, kF32, 1, 8)
  PROBE_PICK(kStatic, kLane, kU32, 1, 8)
  PROBE_PICK(kMask, kLane, kF32, 1, 8)
  PROBE_PICK(kFma, kLane, kF32, 1, 8)
  PROBE_PICK(kStatic, kLane, kF32, 1, 64)
  PROBE_PICK(kMask, kLane, kF32, 1, 64)
  PROBE_PICK(kMask, kLane, kI32, 1, 64)
  PROBE_PICK(kMask, kLane, kBitcast, 1, 64)
  PROBE_PICK(kFma, kLane, kF32, 1, 64)
  PROBE_PICK(kAddMask, kLane, kF32, 4, 32)
  PROBE_PICK(kConvert, kLane, kF32, 4, 32)
#undef PROBE_PICK
  return nullptr;
}

// A layout gather_accum_kernel cannot stage, or an index form it cannot
// offset: a lane gather stages one output row, a sublane gather bl =
// 2^lg_stripe columns, the flat gather one copy; only the static and & mask
// forms hold a table's offset in the set, so only they take several tables
// or a stripe other than 32 copies (one for the flat table).
bool bad_layout(const ProbeParams* p) {
  if (p->lg_stripe < 0 || p->lg_stripe > 5 || (p->ntab & (p->ntab - 1)) != 0)
    return true;
  if (p->form == kFma || p->form == kConvert) return false;
  const bool fixed = p->form == kStatic || p->form == kMask;
  if (!fixed && p->lg_stripe != (p->axis == kFlat ? 0 : 5)) return true;
  if (p->ntab != 1 && !(p->axis == kLane && fixed)) return true;
  if (p->axis == kLane) return p->bs != 1;
  if (p->axis == kSublane) return p->bl != 1 << p->lg_stripe;
  return p->lg_stripe != 0;
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
  if (fn == nullptr || bad_tiles(p) || p->bs * p->bl > 256 ||
      bad_layout(p))
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
  // 64 sets; C a power of two; a block one row (bs 1) of bl pixels.
  if (bad_tiles(p) || (p->C & (p->C - 1)) != 0 || p->unroll != 64 ||
      p->bs != 1 || p->bl > 128)
    return (int)cudaErrorInvalidValue;
  const auto fn = roll_accum_kernel<64>;
  const size_t smem = (size_t)p->C * 4;
  if (const int e = set_smem((const void*)fn, smem)) return e;
  const dim3 grid(p->L / p->bl, p->S, p->copies);
  const dim3 block(p->bl, 1);
  fn<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)sh, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_onehot_dot(const void* tab, const void* idx, void* out,
                     const ProbeParams* p, void* stream) {
  // p->S rows (8 a block), p->L (<= 8) values a row, p->R = 1,536 cells.
  if (p->L <= 0 || p->L > 8 || p->S <= 0 || p->S % kOhRows != 0 ||
      p->R != kOhCells || p->trips < 0 || p->copies < 1 ||
      p->copies > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * kOhWarps * kOhTrips * kOhRows * 8 * 4;
  const dim3 grid(p->S / kOhRows, 1, p->copies), block(32, kOhWarps);
  onehot_dot_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)tab, (const int*)idx, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_transpose(const void* x, void* out, const ProbeParams* p,
                    void* stream) {
  if (p->R <= 0 || p->C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((p->C + kTile - 1) / kTile, (p->R + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  const size_t smem = (size_t)kTile * (kTile + 1) * 4;
  transpose_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, *p);
  return (int)cudaGetLastError();
}

int probe_march_top2(const void* curve, const void* zc, const void* qx,
                     void* out, const ProbeParams* p, void* stream) {
  // p->S rows y, p->C columns (a multiple of 4), p->L pixels (one thread
  // each, whole warps: the sweep votes).
  if (p->S <= 0 || p->C < 4 || p->C % 4 != 0 || p->L <= 0 || p->L > 1024 ||
      p->L % 32 != 0 || p->trips < 0 || p->copies < 1 || p->copies > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)2 * p->C + 4) * 4;
  if (const int e = set_smem((const void*)march_top2_kernel, smem)) return e;
  const dim3 grid(p->S, 1, p->copies), block(p->L);
  march_top2_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)curve, (const float*)zc, (const float*)qx, (float*)out,
      *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
