// K8: one-token attention against the 4-bit PQ KV cache, for sm_90a.
//
// Replaces the plain-JAX function repro/models/kvcache.py::
// pq_decode_attention (no pallas_call: XLA's gather, masked online softmax
// and decode over chunks of 2,048 positions). Computes, for each batch row
// b, KV head k and its g query heads h, over the live positions
// s <= position[b] (s < Smax):
//   score[s] = scale[b,k,h] * sum_m LUT_q8[b,k,h,m,code_m(K[b,s,k])]
//              + bias[b,k,h]                    (quantize_q8, i32 sums)
//            | sum_m LUT_f32[b,k,h,m,code_m(K[b,s,k])]         (f32 LUT)
//   out[b, k*g + h, :] = sum_s softmax(score)[s] * V_cb[k, m, code_m(V)]
// with p rounded to the codebook's type before the product, as the
// reference's p.astype(vh.dtype) does, and the sums in f32. The reference
// masks dead positions to -inf, where they add exactly 0, so the kernel
// reads only the live positions' codes.
//
// Bound on the H100: bytes. At the LM path's shapes (B = 8, KV = 8, g = 2,
// M = 64, ~2,048-2,111 live positions) it reads ~8.65 MB of K and V codes
// a call, ~0.0026 ms at 3.35 TB/s; its work (M look-ups and adds a
// (position, head), hd multiply-adds a (position, head)) is far under
// that at any of the card's rates. What held the first version (one CTA a
// (b, KV head) walking all live positions in 256-position tiles) at 1-4%
// of that bound was latency: 16-256 CTAs, under half of the 132 SMs at
// most shapes, each a serial chain of tiles with four barriers a tile.
//
// Design: a split over the context, then a combine pass (two launches on
// the caller's stream, no atomics: the result does not depend on the
// order in which CTAs run, and a graph replay equals an eager call bit for
// bit).
//   1. Split pass, grid (B * KV, ceil(Smax / 256)): CTA (bk, j) owns the
//      256 positions [256 j, 256 j + 256). The split is fixed, a function
//      of Smax alone and never of `position`, so the decode graph captures
//      one grid and replays it as the position moves in its static buffer.
//      A CTA whose split starts past position[b] writes the empty partial
//      (m = -inf, l = 0) and exits; at ~2,070 live positions of Smax 4,096
//      that is 7 of 16 splits, which cost a launch slot and a read of
//      `position` each. A live CTA
//        - starts cp.async copies of its g LUTs and of its split's K and V
//          code rows (16-, 8- or 4-byte, the widest the rows' alignment
//          takes; byte loads below) into shared memory, each staged row
//          padded to an odd count of 16-byte units (at M/2 = 32 bytes a
//          row, 48: the scoring's 4-byte reads, a row a lane, conflict
//          4-way where 32 would give 8-way); a row of the
//          (b, KV head) is M/2 bytes at a stride of KV * M/2, so at M = 32
//          (internvl2, musicgen) a copy uses half of each 32-byte sector,
//          the other half being the neighbouring head's CTA's;
//        - meanwhile stages the head's value codebook as f32, transposed
//          to [code][dim] with a row of a multiple of 32 words, so that
//          the lanes of a warp (consecutive dims) read distinct banks
//          whatever their codes;
//        - scores its positions, one a thread: each K word read once for
//          all g heads (K1's sum_word for the u8 LUT, the sub-spaces in
//          order for the f32 LUT, so that its sums equal the plain twin's
//          bit for bit);
//        - takes the split's max m_j and sum l_j = sum exp(s - m_j) per
//          head (two barriers), with p rounded to the codebook's type at
//          m_j (the same half unit a term as the reference's rounding at
//          its running max);
//        - sums p * V: thread (group, unit) owns a unit of two dims (one
//          where dsub is odd) of every head, and takes four consecutive
//          positions a step (its group's, then four groups further on):
//          four value codes decoded once for all g heads (a byte and an
//          8-byte codebook load each), then one 16-byte load of a head's
//          four p (stored head-major) for 8 FMAs; four independent loads
//          in flight a step. The groups are added in group order through
//          shared memory;
//        - writes (m_j, l_j, acc_j[hd]) a head to the workspace, f32.
//      The product runs on FMAs, in f32. An mma.sync.m16n8k16 on bf16 p
//      and a one-hot of the codes would fit the bf16 codebooks (p times
//      the one-hot is a histogram of p by code, then 16 FMAs a dim), but
//      its B fragments need four byte loads a lane a k-step, as many
//      shared-memory loads as this product at the paths' g <= 7, and the
//      f32 codebooks would need TF32, which breaks their 1e-5 tolerance.
//      The per-head registers are arrays of G = 1 where g = 1, else of
//      kMaxG (launch_split_g says why).
//   2. Combine pass, one CTA of 128 threads a (b, KV head, query head):
//      one warp reads the splits' maxima, m* = max m_j, the weights
//      e^{m_j - m*} (0 for a dead split, m_j = -inf, whose sum is not
//      read) and L = sum e^{m_j - m*} l_j; then each thread sums its dims'
//      e^{m_j - m*} acc_j in split order over the splits of weight other
//      than 0 and writes acc / max(L, 1e-20) in the output type. Nothing
//      live gives 0, and no -inf - -inf is ever taken. It reads no
//      position: the same pass combines the shards' partials of the
//      sharded mode, concatenated in position order.
//   3. Sub-space mode (a cache sharded on its sub-spaces over n ranks; each
//      rank holds M / n sub-spaces' codes and codebooks and its head_dim
//      slice of q). The scoring pass, grid (B * KV, ceil(Smax / 256)) as
//      the split pass's, stages the g u8 LUTs of the rank's sub-spaces and
//      its split's K code rows with cp.async and writes each live
//      position's i32 sum over them, K1's sum_word as the split pass does
//      (0 at a dead position, so the output is whole). The caller
//      all-reduces the ranks' sums, exactly: the one-rank kernel's integer
//      sums. The value pass is the split pass itself (Sums = true) fed
//      those sums in place of the LUTs and K codes: score = scale * sum +
//      bias as the split pass computes it, so the softmax and p are the
//      one-rank K8's bit for bit; its product walks the rank's hd / n dims
//      (its codebooks), in more groups a dim than at full head_dim, so the
//      value sums add in another order. Bound: bytes, as the split pass
//      (the live codes; in the value pass also the live i32 sums, 4 bytes
//      a (row, query head, position) against M / 2n of codes).
// The zamba2 hybrid's shared attention (head_dim 80, M = 40, g = 1, KV =
// 32) reads its 20-byte rows 4 bytes at a copy, and 240 of 256 threads
// sum its 40 units in 6 groups. Measured (tools/time_k8.py, H100, 700 W):
// 0.014-0.046 ms a call at the six paths' shapes, 0.10-0.26x the first
// version, still 7-31x the bound: each CTA's short chain of global round
// trips, barriers and shared-memory loads, not its bytes, sets the time,
// and more CTAs an SM (launch bounds of 5 and 8 CTAs) were slower.
#include <cuda_bf16.h>
#include <math.h>

#include "fastscan_mma_flat.cuh"  // cp.async, align16, kSmemLimit

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = kThreads;  // positions a split, one a thread
// query heads a KV head: the repo's configs reach 12 (starcoder2-15b's
// 48 over 4); the per-head registers are arrays of this size
constexpr int kMaxG = 12;
constexpr int kCombineThreads = 128;

__host__ __device__ inline int n_splits(int smax) {
  return (smax + kSplit - 1) / kSplit;
}

// Bytes of one staged code row: M/2 bytes rounded up to an odd count of
// 16-byte units (16-byte aligned for the copies, and fewer bank conflicts
// for the scoring's reads, a row a lane, than an even count).
__host__ __device__ inline int code_stride(int mh) {
  return 16 * (((mh + 15) / 16) | 1);
}

// f32 words of one code's row of the staged value codebook.
__host__ __device__ inline int cb_stride(int hd) { return (hd + 31) & ~31; }

// Dims a thread's product unit covers: 2 (one sub-space's pair) where dsub
// is even, else 1.
__host__ __device__ inline int unit_width(int dsub) {
  return dsub % 2 == 0 ? 2 : 1;
}

// Byte offsets in the split pass's shared memory: the g LUTs, the value
// codebook, the split's K codes (after scoring, the product's group sums),
// its V codes, its p (f32, a head's 256 in a row), the max and sum
// partials.
struct Layout {
  size_t lut, cb, kc, vc, p, red, total;
};

__host__ __device__ inline Layout layout(int g, int m, int hd, bool q8) {
  const int units = hd / unit_width(hd / m);
  const size_t rows = static_cast<size_t>(kSplit) * code_stride(m / 2);
  const size_t sums = static_cast<size_t>(kThreads / units) * g * hd * 4;
  Layout l{};
  size_t off = 0;
  l.lut = off;
  off += align16(static_cast<size_t>(g) * m * 16 * (q8 ? 1 : 4));
  l.cb = off;
  off += align16(static_cast<size_t>(16) * cb_stride(hd) * 4);
  l.kc = off;
  off += align16(rows > sums ? rows : sums);
  l.vc = off;
  off += align16(rows);
  l.p = off;
  off += align16(static_cast<size_t>(kSplit) * g * 4);
  l.red = off;
  off += align16(static_cast<size_t>(2) * kWarps * g * 4);
  l.total = off;
  return l;
}

__host__ __device__ inline size_t combine_splits_smem(int nsplit) {
  return align16(static_cast<size_t>(nsplit + 1) * 4);
}

__host__ __device__ inline size_t combine_smem(int smax) {
  return combine_splits_smem(n_splits(smax));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p as the codebook's type holds it (round to nearest even for bf16).
template <typename CB>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename OUT>
__device__ __forceinline__ OUT from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async of W = 16 (through L2 only), 8 or 4 (through L1) bytes.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(W)
                 : "memory");
}

// Starts the copies of n code rows of mh bytes (source rows `stride`
// bytes apart, each W-byte aligned) into rows of `cs` bytes at dst,
// W bytes a copy, neighbouring threads on neighbouring pieces of a row.
template <int W>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src,
                                          int n, int mh, size_t stride,
                                          int cs) {
  const int per_row = mh / W;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * W;
    cp_async<W>(dst + r * cs + c, src + r * stride + c);
  }
}

__device__ __forceinline__ void copy_rows_any(uint8_t* dst,
                                              const uint8_t* src, int n,
                                              int mh, size_t stride, int cs,
                                              int width) {
  if (width == 16) {
    copy_rows<16>(dst, src, n, mh, stride, cs);
  } else if (width == 8) {
    copy_rows<8>(dst, src, n, mh, stride, cs);
  } else if (width == 4) {
    copy_rows<4>(dst, src, n, mh, stride, cs);
  } else {
    for (int i = threadIdx.x; i < n * mh; i += kThreads) {
      const int r = i / mh, c = i % mh;
      dst[r * cs + c] = src[r * stride + c];
    }
  }
}

// Adds the f32 LUT entries of code byte `byte` (sub-spaces 2 byte, 2 byte
// + 1) to acc, one add each, in sub-space order.
__device__ __forceinline__ void add_byte_f32(float& acc, uint32_t b,
                                             const float* lut, int byte) {
  acc += lut[(2 * byte) * 16 + (b & 15u)];
  acc += lut[(2 * byte + 1) * 16 + (b >> 4)];
}

// The split pass; with Sums (the sub-space mode's value pass), the scores
// come from the reduced i32 sums `isums` (B, KV, g, Smax) in place of the
// LUTs and K codes, which are neither read nor staged.
template <typename CB, bool Q8, int G, bool Sums>
__global__ void __launch_bounds__(kThreads) pq_decode_kernel_split(
    const void* __restrict__ table, const float* __restrict__ scale,
    const float* __restrict__ bias, const uint8_t* __restrict__ k_codes,
    const uint8_t* __restrict__ v_codes, const CB* __restrict__ v_cb,
    const int32_t* __restrict__ position, int kv, int g, int m, int dsub,
    int smax, int pos_offset, int width, float* __restrict__ work,
    float* __restrict__ scores, const int32_t* __restrict__ isums) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int hd = m * dsub, mh = m / 2;
  const Layout lay = layout(g, m, hd, Q8);
  const int bk = blockIdx.x, b = bk / kv, kh = bk % kv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // local positions [0, live) are live: global pos_offset + i <= position
  const int live = static_cast<int>(min(
      max(static_cast<long long>(position[b]) + 1 - pos_offset, 0LL),
      static_cast<long long>(smax)));
  const int s0 = split * kSplit;
  // head h's partial: (m_j, l_j, acc_j[hd]) at part + h * hstride
  const size_t hstride = static_cast<size_t>(nsplit) * (hd + 2);
  float* part = work + (static_cast<size_t>(bk) * g * nsplit + split) *
                           (hd + 2);
  if (s0 >= live) {
    if (tid < g) {
      part[tid * hstride] = -INFINITY;
      part[tid * hstride + 1] = 0.f;
    }
    return;
  }
  const int n = min(kSplit, live - s0);
  const int cs = code_stride(mh);
  uint8_t* kcs = smem + lay.kc;
  uint8_t* vcs = smem + lay.vc;

  // the LUTs and the split's code rows, in flight while the codebook is
  // staged
  const size_t row_stride = static_cast<size_t>(kv) * mh;
  const size_t first = ((static_cast<size_t>(b) * smax + s0) * kv + kh) * mh;
  if constexpr (!Sums) {
    const size_t lut_bytes = static_cast<size_t>(g) * m * 16 * (Q8 ? 1 : 4);
    copy_async<kThreads>(smem + lay.lut,
                         static_cast<const uint8_t*>(table) + bk * lut_bytes,
                         lut_bytes);
    copy_rows_any(kcs, k_codes + first, n, mh, row_stride, cs, width);
  }
  copy_rows_any(vcs, v_codes + first, n, mh, row_stride, cs, width);
  cp_async_commit();
  float* cbs = reinterpret_cast<float*>(smem + lay.cb);
  const int cbst = cb_stride(hd);
  const CB* cbg = v_cb + static_cast<size_t>(kh) * hd * 16;
  for (int i = tid; i < 16 * hd; i += kThreads) {
    const int c = i / hd, d = i % hd;
    cbs[c * cbst + d] = to_float(cbg[((d / dsub) * 16 + c) * dsub + d % dsub]);
  }
  float sc[G], bi[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    sc[h] = bi[h] = 0.f;
    if (Q8 && h < g) {
      sc[h] = scale[static_cast<size_t>(bk) * g + h];
      bi[h] = bias[static_cast<size_t>(bk) * g + h];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // scores: position s0 + tid, each K word read once for all heads (or
  // the reduced sums of the sub-space mode)
  float s[G];
  if (Sums && tid < n) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      s[h] = -INFINITY;
      if (h >= g) break;
      const int a = isums[(static_cast<size_t>(bk) * g + h) * smax + s0 + tid];
      s[h] = __fadd_rn(__fmul_rn(sc[h], static_cast<float>(a)), bi[h]);
    }
  } else if (tid < n) {
    const uint8_t* row = kcs + tid * cs;
    const int words = mh / 4;
    if (Q8) {
      const uint8_t* lut = smem + lay.lut;
      int a[G];
#pragma unroll
      for (int h = 0; h < G; ++h) a[h] = 0;
      for (int j = 0; j < words; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * j);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= g) break;
          a[h] += sum_word(w, lut + h * m * 16, 4 * j);
        }
      }
      for (int j = 4 * words; j < mh; ++j) {
        const uint32_t c = row[j];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= g) break;
          const uint8_t* l = lut + h * m * 16;
          a[h] += l[(2 * j) * 16 + (c & 15u)] + l[(2 * j + 1) * 16 + (c >> 4)];
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h)
        s[h] = __fadd_rn(__fmul_rn(sc[h], static_cast<float>(a[h])), bi[h]);
    } else {
      const float* lut = reinterpret_cast<const float*>(smem + lay.lut);
#pragma unroll
      for (int h = 0; h < G; ++h) s[h] = 0.f;
      for (int j = 0; j < words; ++j) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * j);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= g) break;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            add_byte_f32(s[h], (w >> (8 * i)) & 0xffu, lut + h * m * 16,
                         4 * j + i);
        }
      }
      for (int j = 4 * words; j < mh; ++j) {
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h >= g) break;
          add_byte_f32(s[h], row[j], lut + h * m * 16, j);
        }
      }
    }
    if (scores) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= g) break;
        scores[(static_cast<size_t>(bk) * g + h) * smax + s0 + tid] = s[h];
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = -INFINITY;
  }

  // the split's max and sum per head; p rounded at the split's max
  float* red = reinterpret_cast<float*>(smem + lay.red);  // [2][warp][g]
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h >= g) break;
    const float v = warp_max(s[h]);
    if (lane == 0) red[warp * g + h] = v;
  }
  __syncthreads();
  float* ps = reinterpret_cast<float*>(smem + lay.p);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (h >= g) break;
    float mj = red[h];
    for (int w = 1; w < kWarps; ++w) mj = fmaxf(mj, red[w * g + h]);
    const float p = tid < n ? expf(s[h] - mj) : 0.f;
    ps[h * kSplit + tid] = round_to<CB>(p);
    const float w = warp_sum(p);
    if (lane == 0) red[(kWarps + warp) * g + h] = w;
  }
  __syncthreads();

  // the product: thread (grp, u) owns dims d0 .. d0 + uw - 1 of every head
  // over the positions 4 grp .. 4 grp + 3, then 4 groups further on, ...
  // (p is 0 and the codes are any nibble past n: no mask)
  const int uw = unit_width(dsub), units = hd / uw, groups = kThreads / units;
  const int u = tid % units, grp = tid / units;
  float* sums = reinterpret_cast<float*>(smem + lay.kc);  // K codes: done
  if (grp < groups) {
    const int d0 = u * uw, sub = d0 / dsub;
    const uint8_t* vbyte = vcs + (sub >> 1);
    const int shift = (sub & 1) * 4;
    const float* cbu = cbs + d0;
    float acc0[G], acc1[G];
#pragma unroll
    for (int h = 0; h < G; ++h) acc0[h] = acc1[h] = 0.f;
    for (int i = 4 * grp; i < n; i += 4 * groups) {
      float v0[4], v1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t code = (vbyte[(i + q) * cs] >> shift) & 15u;
        if (uw == 2) {
          const float2 v =
              *reinterpret_cast<const float2*>(cbu + code * cbst);
          v0[q] = v.x;
          v1[q] = v.y;
        } else {
          v0[q] = cbu[code * cbst];
          v1[q] = 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= g) break;
        const float4 p = *reinterpret_cast<const float4*>(ps + h * kSplit + i);
        acc0[h] = fmaf(p.x, v0[0], acc0[h]);
        acc1[h] = fmaf(p.x, v1[0], acc1[h]);
        acc0[h] = fmaf(p.y, v0[1], acc0[h]);
        acc1[h] = fmaf(p.y, v1[1], acc1[h]);
        acc0[h] = fmaf(p.z, v0[2], acc0[h]);
        acc1[h] = fmaf(p.z, v1[2], acc1[h]);
        acc0[h] = fmaf(p.w, v0[3], acc0[h]);
        acc1[h] = fmaf(p.w, v1[3], acc1[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) break;
      float* dst = sums + (grp * g + h) * hd + d0;
      dst[0] = acc0[h];
      if (uw == 2) dst[1] = acc1[h];
    }
  }
  __syncthreads();

  // the groups' sums in group order, then (m_j, l_j) a head
  for (int i = tid; i < g * hd; i += kThreads) {
    const int h = i / hd, d = i % hd;
    float a = 0.f;
    for (int gr = 0; gr < groups; ++gr) a += sums[(gr * g + h) * hd + d];
    part[h * hstride + 2 + d] = a;
  }
  if (tid < g) {
    float mj = red[tid], l = 0.f;
    for (int w = 1; w < kWarps; ++w) mj = fmaxf(mj, red[w * g + tid]);
    for (int w = 0; w < kWarps; ++w) l += red[(kWarps + w) * g + tid];
    part[tid * hstride] = mj;
    part[tid * hstride + 1] = l;
  }
}

// The combine pass over nsplit splits in split order: the split pass's
// own, or the shards' concatenated (the sharded mode). A dead split (m_j =
// -inf, its acc_j never written) gets weight 0 and is skipped, as is a
// live one whose weight underflows to 0 (it would add exactly 0), so the
// live splits are summed in the same order, and to the same bits, however
// many dead ones lie around them.
template <typename OUT>
__global__ void __launch_bounds__(kCombineThreads) pq_decode_kernel_combine(
    const float* __restrict__ work, int kvg, int hd, int nsplit,
    OUT* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* wts = reinterpret_cast<float*>(smem);  // e^{m_j - m*}, then L
  const int r = blockIdx.x, tid = threadIdx.x;
  const size_t ps = static_cast<size_t>(hd) + 2;
  const float* part = work + static_cast<size_t>(r) * nsplit * ps;
  if (tid < 32) {
    float mx = -INFINITY;
    for (int j = tid; j < nsplit; j += 32) mx = fmaxf(mx, part[j * ps]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = tid; j < nsplit; j += 32) {
      const float mj = part[j * ps];
      if (mj == -INFINITY) {
        wts[j] = 0.f;
        continue;
      }
      const float e = expf(mj - mx);
      wts[j] = e;
      l += e * part[j * ps + 1];
    }
    l = warp_sum(l);
    if (tid == 0) wts[nsplit] = l;
  }
  __syncthreads();
  const float den = fmaxf(wts[nsplit], 1e-20f);
  for (int d = tid; d < hd; d += kCombineThreads) {
    float a = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const float w = wts[j];
      if (w != 0.f) a = fmaf(w, part[j * ps + 2 + d], a);
    }
    out[static_cast<size_t>(r) * hd + d] = from_float<OUT>(a / den);
  }
}

// Shared memory of the scoring pass: the g u8 LUTs of its M sub-spaces,
// then the split's K code rows.
__host__ __device__ inline size_t scores_smem(int g, int m) {
  return align16(static_cast<size_t>(g) * m * 16) +
         align16(static_cast<size_t>(kSplit) * code_stride(m / 2));
}

// The sub-space mode's scoring pass: sums[b, kh, h, s] = sum over the M
// sub-spaces given of LUT_q8[b, kh, h, m, code_m(K[b, s, kh])] for the live
// positions s <= position[b], 0 past them; one CTA a (b, KV head, split).
template <int G>
__global__ void __launch_bounds__(kThreads) pq_decode_kernel_scores(
    const uint8_t* __restrict__ table, const uint8_t* __restrict__ k_codes,
    const int32_t* __restrict__ position, int kv, int g, int m, int smax,
    int width, int32_t* __restrict__ sums) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int mh = m / 2;
  const int bk = blockIdx.x, b = bk / kv, kh = bk % kv;
  const int s0 = blockIdx.y * kSplit, tid = threadIdx.x;
  const int live = static_cast<int>(
      min(max(static_cast<long long>(position[b]) + 1, 0LL),
          static_cast<long long>(smax)));
  int32_t* out = sums + static_cast<size_t>(bk) * g * smax;
  const bool in = s0 + tid < smax;
  if (s0 >= live) {
    if (in)
      for (int h = 0; h < g; ++h)
        out[static_cast<size_t>(h) * smax + s0 + tid] = 0;
    return;
  }
  const int n = min(kSplit, live - s0);
  const size_t lut_bytes = static_cast<size_t>(g) * m * 16;
  const uint8_t* lut = smem;
  uint8_t* kcs = smem + align16(lut_bytes);
  const int cs = code_stride(mh);
  copy_async<kThreads>(smem, table + bk * lut_bytes, lut_bytes);
  const size_t first = ((static_cast<size_t>(b) * smax + s0) * kv + kh) * mh;
  copy_rows_any(kcs, k_codes + first, n, mh, static_cast<size_t>(kv) * mh,
                cs, width);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int a[G];
#pragma unroll
  for (int h = 0; h < G; ++h) a[h] = 0;
  if (tid < n) {
    const uint8_t* row = kcs + tid * cs;
    const int words = mh / 4;
    for (int j = 0; j < words; ++j) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * j);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= g) break;
        a[h] += sum_word(w, lut + h * m * 16, 4 * j);
      }
    }
    for (int j = 4 * words; j < mh; ++j) {
      const uint32_t c = row[j];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h >= g) break;
        const uint8_t* l = lut + h * m * 16;
        a[h] += l[(2 * j) * 16 + (c & 15u)] + l[(2 * j + 1) * 16 + (c >> 4)];
      }
    }
  }
  if (in) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h >= g) break;
      out[static_cast<size_t>(h) * smax + s0 + tid] = a[h];
    }
  }
}

// The widest copy (16, 8, 4 or 1 bytes) that both code arrays' rows of mh
// bytes take.
inline int copy_width(const void* kc, const void* vc, int mh) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
  for (int w = 16; w >= 4; w /= 2)
    if (mh % w == 0 && a % w == 0) return w;
  return 1;
}

template <typename CB, bool Q8, int G, bool Sums = false>
cudaError_t launch_split(const void* table, const float* scale,
                         const float* bias, const uint8_t* k_codes,
                         const uint8_t* v_codes, const void* v_cb,
                         const int32_t* position, int b, int kv, int g, int m,
                         int dsub, int smax, int pos_offset, float* work,
                         float* scores, cudaStream_t stream,
                         const int32_t* isums = nullptr) {
  const size_t smem = layout(g, m, m * dsub, Q8).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* kernel = pq_decode_kernel_split<CB, Q8, G, Sums>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * kv, n_splits(smax));
  kernel<<<grid, kThreads, smem, stream>>>(
      table, scale, bias, k_codes, v_codes, static_cast<const CB*>(v_cb),
      position, kv, g, m, dsub, smax, pos_offset,
      Sums ? copy_width(v_codes, v_codes, m / 2)
           : copy_width(k_codes, v_codes, m / 2),
      work, scores, isums);
  return cudaGetLastError();
}

// The split pass with register arrays of G = 1 head where g = 1 (zamba2,
// musicgen, the MHA configs), else of kMaxG. At G = 1 a thread needs 40
// registers, so 6 CTAs share an SM where 4 do at 64: 17-20% faster at the
// g = 1 paths' shapes (tools/time_k8.py on the H100). Arrays of 2, 4 or
// 8 heads were 4-9% slower than kMaxG at g = 2, 5 and 6, and so were
// 16-byte reads of the K rows (24-28%, more registers).
template <typename CB, bool Q8>
cudaError_t launch_split_g(const void* table, const float* scale,
                           const float* bias, const uint8_t* k_codes,
                           const uint8_t* v_codes, const void* v_cb,
                           const int32_t* position, int b, int kv, int g,
                           int m, int dsub, int smax, int pos_offset,
                           float* work, float* scores, cudaStream_t stream) {
#define REPRO_K8_SPLIT(G)                                                \
  launch_split<CB, Q8, G>(table, scale, bias, k_codes, v_codes, v_cb,    \
                          position, b, kv, g, m, dsub, smax, pos_offset, \
                          work, scores, stream)
  return g == 1 ? REPRO_K8_SPLIT(1) : REPRO_K8_SPLIT(kMaxG);
#undef REPRO_K8_SPLIT
}

// The combine pass over nsplit splits.
template <typename OUT>
cudaError_t launch_combine(const float* work, int b, int kv, int g, int hd,
                           int nsplit, void* out, cudaStream_t stream) {
  const size_t smem = combine_splits_smem(nsplit);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* kernel = pq_decode_kernel_combine<OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<b * kv * g, kCombineThreads, smem, stream>>>(
      work, kv * g, hd, nsplit, static_cast<OUT*>(out));
  return cudaGetLastError();
}

// The combine pass in the output type.
cudaError_t launch_combine_any(const float* work, int b, int kv, int g,
                               int hd, int nsplit, int out_bf16, void* out,
                               cudaStream_t s) {
  return out_bf16
             ? launch_combine<__nv_bfloat16>(work, b, kv, g, hd, nsplit, out, s)
             : launch_combine<float>(work, b, kv, g, hd, nsplit, out, s);
}

// The split pass of either codebook type and LUT kind.
cudaError_t launch_split_any(const void* table, const void* scale,
                             const void* bias, const void* k_codes,
                             const void* v_codes, const void* v_cb,
                             const void* position, int b, int kv, int g,
                             int m, int dsub, int smax, int pos_offset,
                             int q8, int cb_bf16, float* work, float* scores,
                             cudaStream_t s) {
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* kc = static_cast<const uint8_t*>(k_codes);
  const auto* vc = static_cast<const uint8_t*>(v_codes);
  const auto* pos = static_cast<const int32_t*>(position);
#define REPRO_K8_ANY(CB, Q)                                                 \
  launch_split_g<CB, Q>(table, sc, bi, kc, vc, v_cb, pos, b, kv, g, m, dsub, \
                        smax, pos_offset, work, scores, s)
  if (cb_bf16)
    return q8 ? REPRO_K8_ANY(__nv_bfloat16, true)
              : REPRO_K8_ANY(__nv_bfloat16, false);
  return q8 ? REPRO_K8_ANY(float, true) : REPRO_K8_ANY(float, false);
#undef REPRO_K8_ANY
}

// The scoring pass, per-head registers of G = 1 where g = 1, else kMaxG.
cudaError_t launch_scores(const uint8_t* table, const uint8_t* k_codes,
                          const int32_t* position, int b, int kv, int g,
                          int m, int smax, int32_t* sums, cudaStream_t s) {
  const size_t smem = scores_smem(g, m);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* kernel = g == 1 ? pq_decode_kernel_scores<1>
                        : pq_decode_kernel_scores<kMaxG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * kv, n_splits(smax));
  kernel<<<grid, kThreads, smem, s>>>(table, k_codes, position, kv, g, m, smax,
                                      copy_width(k_codes, k_codes, m / 2),
                                      sums);
  return cudaGetLastError();
}

// The value pass: the split pass fed the reduced sums, either codebook type.
cudaError_t launch_values(const int32_t* isums, const float* scale,
                          const float* bias, const uint8_t* v_codes,
                          const void* v_cb, const int32_t* position, int b,
                          int kv, int g, int m, int dsub, int smax,
                          int cb_bf16, float* work, cudaStream_t s) {
#define REPRO_K8_VALUES(CB, G)                                              \
  launch_split<CB, true, G, true>(nullptr, scale, bias, nullptr, v_codes,  \
                                  v_cb, position, b, kv, g, m, dsub, smax, \
                                  0, work, nullptr, s, isums)
  if (cb_bf16)
    return g == 1 ? REPRO_K8_VALUES(__nv_bfloat16, 1)
                  : REPRO_K8_VALUES(__nv_bfloat16, kMaxG);
  return g == 1 ? REPRO_K8_VALUES(float, 1) : REPRO_K8_VALUES(float, kMaxG);
#undef REPRO_K8_VALUES
}

inline bool dims_ok(int b, int kv, int g, int m, int dsub, int smax) {
  return g >= 1 && g <= kMaxG && m >= 2 && m % 2 == 0 && dsub >= 1 &&
         m * dsub <= kThreads && b >= 1 && kv >= 1 && smax >= 1;
}

}  // namespace

// Shared memory (bytes) one CTA of the split pass needs at (g, M,
// head_dim, quantize_q8): the wrapper checks it against the card's limit
// before launching.
extern "C" long long repro_pq_decode_attention_smem(int g, int m, int hd,
                                                    int q8) {
  return static_cast<long long>(layout(g, m, hd, q8 != 0).total);
}

// Shared memory (bytes) one CTA of the combine pass needs at Smax.
extern "C" long long repro_pq_decode_combine_smem(int smax) {
  return static_cast<long long>(combine_smem(smax));
}

// Shared memory (bytes) one CTA of the combine pass needs over nsplit
// gathered splits (the sharded mode).
extern "C" long long repro_pq_decode_combine_splits_smem(int nsplit) {
  return static_cast<long long>(combine_splits_smem(nsplit));
}

// Launch both passes on `stream`; returns the first cudaGetLastError()
// that is not 0 (0 = ok). table: (B, KV, g, M, 16) u8 with scale and
// summed bias (B, KV, g) f32 when q8, else f32 (scale and bias unused);
// k_codes, v_codes: (B, Smax, KV, M/2) u8; v_cb: (KV, M, 16, dsub) bf16
// or f32; position: (B,) i32; out: (B, KV * g, M * dsub) bf16 or f32;
// scores: null, or (B, KV, g, Smax) f32 that gets each live position's
// score; work: (B, KV, g, ceil(Smax / 256), M * dsub + 2) f32, the split
// pass's partials.
extern "C" int repro_pq_decode_attention(
    const void* table, const void* scale, const void* bias,
    const void* k_codes, const void* v_codes, const void* v_cb,
    const void* position, int b, int kv, int g, int m, int dsub, int smax,
    int q8, int cb_bf16, int out_bf16, void* out, void* scores, void* work,
    void* stream) {
  if (!dims_ok(b, kv, g, m, dsub, smax))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wk = static_cast<float*>(work);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split_any(
      table, scale, bias, k_codes, v_codes, v_cb, position, b, kv, g, m, dsub,
      smax, 0, q8, cb_bf16, wk, static_cast<float*>(scores), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_combine_any(wk, b, kv, g, m * dsub,
                                             n_splits(smax), out_bf16, out,
                                             s));
}

// The split pass alone over a shard of the cache (K8's sharded mode):
// k_codes, v_codes (B, Smax, KV, M/2) are the shard's positions, local
// position i being global position pos_offset + i; work (B, KV, g,
// ceil(Smax / 256), M * dsub + 2) f32 gets the shard's partials. Other
// arguments as repro_pq_decode_attention's.
extern "C" int repro_pq_decode_split(
    const void* table, const void* scale, const void* bias,
    const void* k_codes, const void* v_codes, const void* v_cb,
    const void* position, int b, int kv, int g, int m, int dsub, int smax,
    int pos_offset, int q8, int cb_bf16, void* work, void* stream) {
  if (!dims_ok(b, kv, g, m, dsub, smax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_split_any(
      table, scale, bias, k_codes, v_codes, v_cb, position, b, kv, g, m, dsub,
      smax, pos_offset, q8, cb_bf16, static_cast<float*>(work), nullptr,
      static_cast<cudaStream_t>(stream)));
}

// The combine pass alone over work (B, KV, g, nsplit, hd + 2) f32, the
// shards' partials concatenated on the split axis in position order; out
// (B, KV * g, hd) bf16 or f32.
extern "C" int repro_pq_decode_combine(const void* work, int b, int kv, int g,
                                       int hd, int nsplit, int out_bf16,
                                       void* out, void* stream) {
  if (b < 1 || kv < 1 || g < 1 || hd < 1 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_combine_any(
      static_cast<const float*>(work), b, kv, g, hd, nsplit, out_bf16, out,
      static_cast<cudaStream_t>(stream)));
}

// Shared memory (bytes) one CTA of the sub-space mode's scoring pass needs
// at (g, M).
extern "C" long long repro_pq_decode_scores_smem(int g, int m) {
  return static_cast<long long>(scores_smem(g, m));
}

// The sub-space mode's scoring pass: table (B, KV, g, M, 16) u8, the LUTs
// of the rank's M sub-spaces; k_codes (B, Smax, KV, M/2) u8, their codes;
// position (B,) i32; sums (B, KV, g, Smax) i32 gets each live position's
// sum over them, 0 past the position.
extern "C" int repro_pq_decode_scores(const void* table, const void* k_codes,
                                      const void* position, int b, int kv,
                                      int g, int m, int smax, void* sums,
                                      void* stream) {
  if (!dims_ok(b, kv, g, m, 1, smax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_scores(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(k_codes),
      static_cast<const int32_t*>(position), b, kv, g, m, smax,
      static_cast<int32_t*>(sums), static_cast<cudaStream_t>(stream)));
}

// The sub-space mode's value pass: sums (B, KV, g, Smax) i32, the whole
// LUT's sums (the ranks' scoring passes all-reduced); scale and summed bias
// (B, KV, g) f32 of the whole LUT; v_codes (B, Smax, KV, M/2) u8 and v_cb
// (KV, M, 16, dsub) bf16 or f32 of the rank's M sub-spaces; position (B,)
// i32; work (B, KV, g, ceil(Smax / 256), M * dsub + 2) f32 gets the split
// partials of the rank's head_dim slice (pq_decode_combine takes them).
extern "C" int repro_pq_decode_values(const void* sums, const void* scale,
                                      const void* bias, const void* v_codes,
                                      const void* v_cb, const void* position,
                                      int b, int kv, int g, int m, int dsub,
                                      int smax, int cb_bf16, void* work,
                                      void* stream) {
  if (!dims_ok(b, kv, g, m, dsub, smax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_values(
      static_cast<const int32_t*>(sums), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const uint8_t*>(v_codes),
      v_cb, static_cast<const int32_t*>(position), b, kv, g, m, dsub, smax,
      cb_bf16, static_cast<float*>(work), static_cast<cudaStream_t>(stream)));
}
