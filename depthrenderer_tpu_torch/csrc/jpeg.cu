// jpeg.cu - baseline JPEG (4:2:0, Annex K tables) of a frame group on the
// card, byte for byte what csrc/frameops.c's jpeg_encode writes.
//
// It replaces no TPU kernel: the JAX package encodes on the host. The host
// encoder took ~80 ms a 1080p frame on one thread while the card idled, so
// the encode moved here and the card hands back ~0.6 MB of JPEG a frame in
// place of 8.3 MB of RGBA. Bound: the frame read once (4 bytes a pixel) and
// the JPEG written once. Launches, in stream order, over a group of F
// frames (ops/jpeg.py documents the stages):
//
//   jpeg_dct_kernel     (ceil(mcu_w / 8), mcu_h, F) x 384: a CTA stages a
//                       clamped 128x16 strip in shared memory and turns its
//                       8 MCUs into 48 quantised blocks, 8 threads a block
//                       (a row, then a column of the FDCT, then 8 zigzag
//                       positions); 48 threads then count the AC bits.
//   jpeg_scan_kernel    F x 1024: the blocks' bits (DC difference included)
//                       and their exclusive scan; zeroes the frame's words.
//   jpeg_pack_kernel    (ceil(nblk / 128), F) x 128: one block a thread,
//                       MSB first at its offset; whole words stored, the
//                       two shared with neighbours atomicOr'd.
//   jpeg_ffcount_kernel (chunks, F) x 256: 0xFF bytes of each chunk.
//   jpeg_layout_kernel  1 x 256: chunk offsets, frame sizes and offsets.
//   jpeg_stuff_kernel   (chunks, F) x 256: header, stuffed bytes, EOI.
//
// Every float expression is frameops.c's, in its order; the file is built
// with --fmad=false, so nothing is contracted, and lrintf (round to nearest
// even) is __float2int_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMcus = 8;                 // MCUs a dct CTA (one MCU row)
constexpr int kBlocks = 6 * kMcus;       // 8x8 blocks a dct CTA
constexpr int kDctThreads = 8 * kBlocks; // 384
constexpr int kStrip = 16 * kMcus;       // strip width in pixels
constexpr int kScanThreads = 1024;
constexpr int kPackThreads = 128;
constexpr int kStuffThreads = 256;
constexpr int kTileWords = 4 * kStuffThreads;  // one uint4 a thread

__constant__ unsigned char kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

}  // namespace

// A quality's tables (ops/jpeg.py Tables.blob): reciprocal quantisers in
// natural order, Huffman codes as code | size << 16; [0] luma, [1] chroma.
struct JpegTables {
  float rq[2][64];
  uint32_t dc[2][16];
  uint32_t ac[2][256];
};

// Mirror of ops/jpeg.py _JpegParams (field order and types must match).
struct JpegParams {
  long long frame_stride;  // pixels from one frame to the next
  long long word_cap;      // words of a frame's bit buffer (a multiple of 4)
  long long out_cap;       // bytes of the output buffer
  int row_stride;          // pixels from one row to the next
  int width, height, frames;
  int mcu_w, mcu_h, nblk;  // nblk = 6 * mcu_w * mcu_h
  int hdr_len;             // bytes of SOI..SOS
  int chunks;              // CTAs a frame in the stuffing passes
};

namespace {

// frameops.c's dct1d_aan, stride 1 over 8 values.
__device__ __forceinline__ void dct1d_aan(float* d) {
  float tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  float tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  float tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  float tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  d[0] = tmp10 + tmp11;
  d[4] = tmp10 - tmp11;
  float z1 = (tmp12 + tmp13) * 0.707106781f;
  d[2] = tmp13 + z1;
  d[6] = tmp13 - z1;
  tmp10 = tmp4 + tmp5;
  tmp11 = tmp5 + tmp6;
  tmp12 = tmp6 + tmp7;
  float z5 = (tmp10 - tmp12) * 0.382683433f;
  float z2 = 0.541196100f * tmp10 + z5;
  float z4 = 1.306562965f * tmp12 + z5;
  float z3 = tmp11 * 0.707106781f;
  float z11 = tmp7 + z3, z13 = tmp7 - z3;
  d[5] = z13 + z2;
  d[3] = z13 - z2;
  d[1] = z11 + z4;
  d[7] = z11 - z4;
}

__device__ __forceinline__ int bitlen(int v) {
  const int a = v < 0 ? -v : v;
  return 32 - __clz(a);
}

// The previous block of block i's component in MCU order, -1 for none.
__device__ __forceinline__ int prev_block(int i) {
  const int kind = i % 6;
  const int prev = kind == 0 ? i - 3 : (kind < 4 ? i - 1 : i - 6);
  return prev;  // negative only in the first MCU
}

__device__ __forceinline__ int dc_diff(const int* dc, int i) {
  const int prev = prev_block(i);
  return dc[i] - (prev >= 0 ? dc[prev] : 0);
}

// Bits of a block's AC codes (encode_block's loop); z in zigzag order,
// size[] the AC table's code sizes.
__device__ int ac_bits(const short* z, const uint32_t* size) {
  int bits = 0, run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = z[k];
    if (v == 0) {
      ++run;
      continue;
    }
    const int sz = bitlen(v);
    bits += (run >> 4) * size[0xF0] + size[((run & 15) << 4 | sz) & 255] + sz;
    run = 0;
  }
  if (run) bits += size[0];
  return bits;
}

// MSB-first bit writer into big-endian words, from bit `pos` on. Words it
// fills alone are stored; the first and the last may hold a neighbour's
// bits and are atomicOr'd (the buffer starts zeroed).
struct BitSink {
  uint32_t* words;
  long long wi;
  unsigned long long acc;
  int n;
  bool first;

  __device__ BitSink(uint32_t* w, unsigned int pos)
      : words(w), wi(pos >> 5), acc(0), n(pos & 31), first(true) {}

  __device__ void put(uint32_t v, int len) {
    acc = (acc << len) | (v & ((1u << len) - 1u));
    n += len;
    if (n >= 32) {
      n -= 32;
      store((uint32_t)(acc >> n));
      acc &= (1ull << n) - 1ull;
    }
  }

  __device__ void store(uint32_t w) {
    w = __byte_perm(w, 0, 0x0123);
    if (first)
      atomicOr(words + wi, w);
    else
      words[wi] = w;
    first = false;
    ++wi;
  }

  __device__ void finish() {
    if (n > 0)
      atomicOr(words + wi, __byte_perm((uint32_t)(acc << (32 - n)), 0, 0x0123));
  }
};

// Exclusive scan of v over the CTA; returns the thread's prefix and sets
// *total. `sh` holds 33 values.
__device__ long long block_scan(long long v, long long* sh, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      const long long t = sh[k];
      sh[k] = s;
      s += t;
    }
    sh[32] = s;
  }
  __syncthreads();
  const long long before = sh[warp] + x - v;
  *total = sh[32];
  __syncthreads();  // sh is reused by the next call
  return before;
}

__global__ void __launch_bounds__(kDctThreads)
jpeg_dct_kernel(const uint32_t* __restrict__ px,
                const JpegTables* __restrict__ tb, short* __restrict__ coef,
                int* __restrict__ dc, int* __restrict__ acbits, JpegParams p) {
  __shared__ uint32_t tile[16][kStrip + 1];  // +1: rows on other banks
  __shared__ float blk[kBlocks][72];  // 8 rows of 9: conflict-free rows
  __shared__ uint4 zq[kBlocks][8];  // each block's 64 int16, zigzag order
  __shared__ float rq[2][64];
  __shared__ uint32_t acsize[2][256];
  __shared__ unsigned char zig[64];

  const int tid = threadIdx.x, f = blockIdx.z, my = blockIdx.y;
  const int mx0 = blockIdx.x * kMcus;
  const uint32_t* img = px + f * p.frame_stride;
  for (int i = tid; i < 128; i += kDctThreads) rq[i >> 6][i & 63] = tb->rq[i >> 6][i & 63];
  for (int i = tid; i < 512; i += kDctThreads)
    acsize[i >> 8][i & 255] = tb->ac[i >> 8][i & 255] >> 16;
  if (tid < 64) zig[tid] = kZigzag[tid];
  // The strip, edges clamped as frameops.c clamps them.
  for (int i = tid; i < 16 * kStrip; i += kDctThreads) {
    const int yy = i / kStrip, xx = i % kStrip;
    const int sy = min(my * 16 + yy, p.height - 1);
    const int sx = min(mx0 * 16 + xx, p.width - 1);
    tile[yy][xx] = img[(long long)sy * p.row_stride + sx];
  }
  __syncthreads();

  const int b = tid >> 3, r = tid & 7;  // block of the strip, its row
  const int j = b / 6, kind = b % 6;    // MCU of the strip, Y0-3 / Cb / Cr
  float d[8];
  if (kind < 4) {
    const int yy = (kind >> 1) * 8 + r, x0 = j * 16 + (kind & 1) * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t v = tile[yy][x0 + c];
      const float R = (float)(v & 255), G = (float)((v >> 8) & 255),
                  B = (float)((v >> 16) & 255);
      d[c] = 0.299f * R + 0.587f * G + 0.114f * B - 128.f;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int x = j * 16 + 2 * c;
      const uint32_t q0 = tile[2 * r][x], q1 = tile[2 * r][x + 1],
                     q2 = tile[2 * r + 1][x], q3 = tile[2 * r + 1][x + 1];
      const float r4 = (float)((q0 & 255) + (q1 & 255) + (q2 & 255) + (q3 & 255)) * 0.25f;
      const float g4 = (float)(((q0 >> 8) & 255) + ((q1 >> 8) & 255) +
                               ((q2 >> 8) & 255) + ((q3 >> 8) & 255)) * 0.25f;
      const float b4 = (float)(((q0 >> 16) & 255) + ((q1 >> 16) & 255) +
                               ((q2 >> 16) & 255) + ((q3 >> 16) & 255)) * 0.25f;
      d[c] = kind == 4 ? -0.168736f * r4 - 0.331264f * g4 + 0.5f * b4
                       : 0.5f * r4 - 0.418688f * g4 - 0.081312f * b4;
    }
  }
  dct1d_aan(d);
#pragma unroll
  for (int c = 0; c < 8; ++c) blk[b][r * 9 + c] = d[c];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = blk[b][k * 9 + r];
  dct1d_aan(d);
#pragma unroll
  for (int k = 0; k < 8; ++k) blk[b][k * 9 + r] = d[k];
  __syncthreads();

  const float* q = rq[kind < 4 ? 0 : 1];
  uint32_t zz[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int nat = zig[r * 8 + k];
    const short v = (short)__float2int_rn(blk[b][(nat >> 3) * 9 + (nat & 7)] * q[nat]);
    if (k & 1)
      zz[k >> 1] |= (uint32_t)(unsigned short)v << 16;
    else
      zz[k >> 1] = (unsigned short)v;
  }
  const uint4 z = make_uint4(zz[0], zz[1], zz[2], zz[3]);
  zq[b][r] = z;
  const bool live = mx0 + j < p.mcu_w;
  const long long gb = (long long)f * p.nblk + 6 * (my * p.mcu_w + mx0 + j) + kind;
  if (live)
    *reinterpret_cast<uint4*>(coef + gb * 64 + r * 8) = z;
  __syncthreads();
  if (tid < kBlocks) {
    const int jb = tid / 6, kb = tid % 6;
    if (mx0 + jb < p.mcu_w) {
      const long long g = (long long)f * p.nblk + 6 * (my * p.mcu_w + mx0 + jb) + kb;
      const short* zb = reinterpret_cast<const short*>(zq[tid]);
      dc[g] = zb[0];
      acbits[g] = ac_bits(zb, acsize[kb < 4 ? 0 : 1]);
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
jpeg_scan_kernel(const int* __restrict__ dc, int* acbits,
                 const JpegTables* __restrict__ tb, uint32_t* words,
                 long long* fstat, JpegParams p) {
  __shared__ long long sh[33];
  __shared__ uint32_t dcsize[2][16];
  const int f = blockIdx.x, tid = threadIdx.x;
  if (tid < 32) dcsize[tid >> 4][tid & 15] = tb->dc[tid >> 4][tid & 15] >> 16;
  __syncthreads();
  const int* d = dc + (long long)f * p.nblk;
  int* bits = acbits + (long long)f * p.nblk;  // in: AC bits; out: offsets
  long long carry = 0;
  for (int base = 0; base < p.nblk; base += 4 * kScanThreads) {
    int v[4];
    long long s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + 4 * tid + k;
      v[k] = 0;
      if (i < p.nblk) {
        const int diff = dc_diff(d, i), n = bitlen(diff);
        v[k] = bits[i] + (int)dcsize[i % 6 < 4 ? 0 : 1][min(n, 15)] + n;
      }
      s += v[k];
    }
    long long total;
    long long off = carry + block_scan(s, sh, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + 4 * tid + k;
      if (i < p.nblk) bits[i] = (int)off;
      off += v[k];
    }
    carry += total;
  }
  // carry: the frame's entropy bits; the pad to a byte follows them.
  const long long nbytes = (carry + 7) >> 3;
  const long long nwords = ((nbytes + 3) >> 2) + 3 & ~3LL;
  if (tid == 0) {
    fstat[4 * f + 0] = carry;
    fstat[4 * f + 1] = nbytes;
  }
  uint4* w4 = reinterpret_cast<uint4*>(words + (long long)f * p.word_cap);
  for (long long w = tid; w < nwords / 4; w += kScanThreads) w4[w] = make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kPackThreads)
jpeg_pack_kernel(const short* __restrict__ coef, const int* __restrict__ dc,
                 const int* __restrict__ offsets,
                 const JpegTables* __restrict__ tb, uint32_t* words,
                 const long long* __restrict__ fstat, JpegParams p) {
  __shared__ uint32_t huff_ac[2][256];
  __shared__ uint32_t huff_dc[2][16];
  const int f = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < 512; i += kPackThreads) huff_ac[i >> 8][i & 255] = tb->ac[i >> 8][i & 255];
  if (tid < 32) huff_dc[tid >> 4][tid & 15] = tb->dc[tid >> 4][tid & 15];
  __syncthreads();
  const int i = blockIdx.x * kPackThreads + tid;
  if (i >= p.nblk) return;
  const long long fb = (long long)f * p.nblk;
  const int c = i % 6 < 4 ? 0 : 1;
  const uint32_t* ac = huff_ac[c];
  BitSink out(words + (long long)f * p.word_cap, (unsigned int)offsets[fb + i]);
  const int diff = dc_diff(dc + fb, i), s = bitlen(diff);
  const uint32_t hd = huff_dc[c][min(s, 15)];
  out.put(hd & 0xFFFF, hd >> 16);
  if (s) out.put((uint32_t)(diff < 0 ? diff + (1 << s) - 1 : diff), s);
  const short* z = coef + (fb + i) * 64;
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = z[k];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) out.put(ac[0xF0] & 0xFFFF, ac[0xF0] >> 16);
    const int sz = bitlen(v);
    const uint32_t h = ac[(run << 4 | sz) & 255];
    out.put(h & 0xFFFF, h >> 16);
    out.put((uint32_t)(v < 0 ? v + (1 << sz) - 1 : v), sz);
    run = 0;
  }
  if (run) out.put(ac[0] & 0xFFFF, ac[0] >> 16);
  if (i == p.nblk - 1) {  // bw_flush: pad the last byte with 1s
    const int pad = (int)(-fstat[4 * f] & 7);
    out.put((1u << pad) - 1u, pad);
  }
  out.finish();
}

// The words [lo, hi) of chunk c of a frame of `nwords` words.
__device__ __forceinline__ void chunk_range(long long nwords, int chunks, int c,
                                            long long* lo, long long* hi) {
  const long long per = ((nwords + chunks - 1) / chunks + kTileWords - 1) /
                        kTileWords * kTileWords;
  *lo = min(nwords, per * c);
  *hi = min(nwords, per * (c + 1));
}

// 0xFF bytes among the 16 bytes of u from byte index q0 on, below nbytes;
// bit k of *mask set for byte k.
__device__ __forceinline__ int count_ff(uint4 u, long long q0, long long nbytes,
                                        unsigned* mask) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t byte = (w[k >> 2] >> (8 * (k & 3))) & 255;
    if (byte == 255 && q0 + k < nbytes) m |= 1u << k;
  }
  *mask = m;
  return __popc(m);
}

__global__ void __launch_bounds__(kStuffThreads)
jpeg_ffcount_kernel(const uint32_t* __restrict__ words,
                    const long long* __restrict__ fstat, int* ffcnt,
                    JpegParams p) {
  __shared__ int sh[kStuffThreads / 32];
  const int c = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
  const long long nbytes = fstat[4 * f + 1], nwords = (nbytes + 3) >> 2;
  long long lo, hi;
  chunk_range(nwords, p.chunks, c, &lo, &hi);
  const uint4* w4 = reinterpret_cast<const uint4*>(words + (long long)f * p.word_cap);
  int n = 0;
  for (long long w = lo + 4 * tid; w < hi; w += kTileWords) {
    unsigned m;
    n += count_ff(w4[w / 4], 4 * w, nbytes, &m);
  }
  for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((tid & 31) == 0) sh[tid >> 5] = n;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int k = 0; k < kStuffThreads / 32; ++k) s += sh[k];
    ffcnt[f * p.chunks + c] = s;
  }
}

__global__ void jpeg_layout_kernel(int* ffcnt, long long* fstat,
                                   long long* offsets, JpegParams p) {
  for (int f = threadIdx.x; f < p.frames; f += blockDim.x) {
    long long s = 0;
    for (int c = 0; c < p.chunks; ++c) {
      const int n = ffcnt[f * p.chunks + c];
      ffcnt[f * p.chunks + c] = (int)s;
      s += n;
    }
    fstat[4 * f + 2] = s;
    fstat[4 * f + 3] = p.hdr_len + fstat[4 * f + 1] + s + 2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long o = 0;
    for (int f = 0; f < p.frames; ++f) {
      offsets[f] = o;
      o += fstat[4 * f + 3];
    }
    offsets[p.frames] = o;
  }
}

__global__ void __launch_bounds__(kStuffThreads)
jpeg_stuff_kernel(const uint32_t* __restrict__ words,
                  const long long* __restrict__ fstat,
                  const int* __restrict__ ffoff,
                  const long long* __restrict__ offsets,
                  const unsigned char* __restrict__ hdr, unsigned char* out,
                  JpegParams p) {
  __shared__ long long sh[33];
  const int c = blockIdx.x, f = blockIdx.y, tid = threadIdx.x;
  const long long nbytes = fstat[4 * f + 1], nwords = (nbytes + 3) >> 2;
  unsigned char* dst = out + offsets[f];
  if (c == 0) {
    for (int k = tid; k < p.hdr_len; k += kStuffThreads) dst[k] = hdr[k];
    if (tid == 0) {
      const long long end = fstat[4 * f + 3];
      dst[end - 2] = 0xFF;
      dst[end - 1] = 0xD9;
    }
  }
  dst += p.hdr_len;
  long long lo, hi;
  chunk_range(nwords, p.chunks, c, &lo, &hi);
  const uint4* w4 = reinterpret_cast<const uint4*>(words + (long long)f * p.word_cap);
  long long carry = ffoff[f * p.chunks + c];
  for (long long t0 = lo; t0 < hi; t0 += kTileWords) {
    const long long w = t0 + 4 * tid;
    const uint4 u = w < hi ? w4[w / 4] : make_uint4(0, 0, 0, 0);
    unsigned mask = 0;
    const int n = w < hi ? count_ff(u, 4 * w, nbytes, &mask) : 0;
    long long total;
    long long at = 4 * w + carry + block_scan(n, sh, &total);
    if (w < hi) {
      const uint32_t ws[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (4 * w + k >= nbytes) break;
        dst[at++] = (unsigned char)(ws[k >> 2] >> (8 * (k & 3)));
        if (mask >> k & 1) dst[at++] = 0;
      }
    }
    carry += total;
  }
}

}  // namespace

extern "C" {

const char* jpeg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Encode the group: px (frames, rows, row_stride) 4-byte pixels; scratch
// coef (F, nblk, 64) int16, dc and acbits (F, nblk) int32, words (F,
// word_cap) uint32, ffcnt (F, chunks) int32, fstat (F, 4) int64; results
// offsets (F + 1) int64 and out (out_cap) uint8, frame f's JPEG at
// [offsets[f], offsets[f + 1]). Returns a cudaError_t.
int jpeg_encode_group(const void* px, const void* tables, const void* hdr,
                      void* coef, void* dc, void* acbits, void* words,
                      void* ffcnt, void* fstat, void* offsets, void* out,
                      const JpegParams* p, void* stream) {
  if (p->frames <= 0 || p->width <= 0 || p->height <= 0 || p->chunks <= 0 ||
      p->word_cap % 4 != 0)
    return (int)cudaErrorInvalidValue;
    const JpegTables* tb = (const JpegTables*)tables;
  cudaError_t e;
  jpeg_dct_kernel<<<dim3((p->mcu_w + kMcus - 1) / kMcus, p->mcu_h, p->frames),
                    kDctThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)px, tb, (short*)coef,
                                         (int*)dc, (int*)acbits, *p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_scan_kernel<<<p->frames, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int*)dc, (int*)acbits, tb, (uint32_t*)words, (long long*)fstat, *p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_pack_kernel<<<dim3((p->nblk + kPackThreads - 1) / kPackThreads, p->frames),
                     kPackThreads, 0, (cudaStream_t)stream>>>((const short*)coef, (const int*)dc,
                                           (const int*)acbits, tb, (uint32_t*)words,
                                           (const long long*)fstat, *p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_ffcount_kernel<<<dim3(p->chunks, p->frames), kStuffThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const long long*)fstat, (int*)ffcnt, *p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_layout_kernel<<<1, 256, 0, (cudaStream_t)stream>>>((int*)ffcnt, (long long*)fstat,
                                       (long long*)offsets, *p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  jpeg_stuff_kernel<<<dim3(p->chunks, p->frames), kStuffThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const long long*)fstat, (const int*)ffcnt,
      (const long long*)offsets, (const unsigned char*)hdr, (unsigned char*)out,
      *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
