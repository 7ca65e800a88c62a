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
// that at any of the card's rates.
//
// Design (a first, simple one):
//   - one CTA of 256 threads per (b, KV head); its g u8 (or f32) LUTs and
//     the head's value codebook (as f32) staged in shared memory;
//   - the live positions in tiles of 256: thread t sums position t's key
//     row against each head's LUT with K1's row_sum / sum_word
//     (fastscan_common.cuh), and copies the value row to shared memory;
//   - a block max and sum per head each tile (an online softmax, as the
//     reference's chunks, at the tile's granularity);
//   - the product: thread (group, d) owns output dim d of every head over
//     a group of the tile's positions (256 / hd groups), decoding the
//     value code from shared memory; the groups are summed at the end in
//     group order.
// B * KV CTAs (64 at the path's shapes) fill under half of the 132 SMs: a
// split over the context with a combine pass is the lever left for later.
// The zamba2 hybrid's shared attention (head_dim 80, M = 40, g = 1, KV =
// 32) runs 256 CTAs; its 80-dim product uses 3 groups of 80 threads and
// leaves 16 idle, and its 20-byte rows load 4 bytes at a time.
#include <cuda_bf16.h>
#include <math.h>

#include <algorithm>

#include "fastscan_common.cuh"

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // positions a tile, one a thread
// query heads a KV head: the repo's configs reach 12 (starcoder2-15b's
// 48 over 4); the per-head registers are arrays of this size
constexpr int kMaxG = 12;
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets in shared memory: the g LUTs, the value codebook (hd * 16
// f32), the tile's value codes, its p (g f32 a position), the reductions.
struct Layout {
  size_t lut, cb, vcodes, p, red, total;
};

__host__ __device__ inline Layout layout(int g, int m, int hd, bool q8) {
  Layout l{};
  size_t off = 0;
  l.lut = off;
  off += align16(static_cast<size_t>(g) * m * 16 * (q8 ? 1 : 4));
  l.cb = off;
  off += align16(static_cast<size_t>(hd) * 16 * 4);
  l.vcodes = off;
  off += align16(static_cast<size_t>(kTile) * (m / 2));
  l.p = off;
  off += align16(static_cast<size_t>(kTile) * g * 4);
  l.red = off;
  off += align16(static_cast<size_t>(kThreads) * g * 4 + kMaxG * 4);
  l.total = off;
  return l;
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

// Sum of one packed row of mh bytes against an (M, 16) f32 LUT.
__device__ __forceinline__ float row_sum_f32(const uint8_t* row,
                                             const float* lut, int mh) {
  float acc = 0.f;
  for (int j = 0; j < mh; ++j) {
    const uint32_t b = row[j];
    acc += lut[(2 * j) * 16 + (b & 15u)];
    acc += lut[(2 * j + 1) * 16 + (b >> 4)];
  }
  return acc;
}

template <typename CB, typename OUT, bool Q8>
__global__ void __launch_bounds__(kThreads) pq_decode_kernel(
    const void* __restrict__ table, const float* __restrict__ scale,
    const float* __restrict__ bias, const uint8_t* __restrict__ k_codes,
    const uint8_t* __restrict__ v_codes, const CB* __restrict__ v_cb,
    const int32_t* __restrict__ position, int kv, int g, int m, int dsub,
    int smax, int vec, OUT* __restrict__ out, float* __restrict__ scores) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int hd = m * dsub, mh = m / 2;
  const Layout lay = layout(g, m, hd, Q8);
  const int b = blockIdx.x / kv, kh = blockIdx.x % kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bk = static_cast<size_t>(b) * kv + kh;

  // this (b, KV head)'s g LUTs and the head's value codebook, as f32
  const size_t lut_bytes = static_cast<size_t>(g) * m * 16 * (Q8 ? 1 : 4);
  stage_bytes(smem + lay.lut,
              static_cast<const uint8_t*>(table) + bk * lut_bytes, lut_bytes);
  float* cbs = reinterpret_cast<float*>(smem + lay.cb);
  const CB* cbg = v_cb + static_cast<size_t>(kh) * hd * 16;
  for (int i = tid; i < hd * 16; i += kThreads) cbs[i] = to_float(cbg[i]);
  uint8_t* vcs = smem + lay.vcodes;
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* lsum = red + kThreads * g;

  float sc[kMaxG], bi[kMaxG], mrun[kMaxG], lrun[kMaxG], acc[kMaxG];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) {
    sc[h] = bi[h] = 0.f;
    if (Q8 && h < g) {
      sc[h] = scale[bk * g + h];
      bi[h] = bias[bk * g + h];
    }
    mrun[h] = -INFINITY;
    lrun[h] = 0.f;
    acc[h] = 0.f;
  }
  const int live = min(max(position[b] + 1, 0), smax);
  // the product's work split: output dim d of a group of positions
  const int groups = kThreads / hd;
  const int d = tid % hd, grp = tid / hd;
  const int msub = d / dsub, dd = d % dsub;
  const size_t row_stride = static_cast<size_t>(kv) * mh;
  const size_t base = (static_cast<size_t>(b) * smax * kv + kh) * mh;
  __syncthreads();

  for (int t0 = 0; t0 < live; t0 += kTile) {
    const int n = min(kTile, live - t0);
    float s[kMaxG];
    if (tid < n) {
      const size_t row = base + static_cast<size_t>(t0 + tid) * row_stride;
      const uint8_t* krow = k_codes + row;
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h >= g) break;
        if (Q8) {
          const int a = row_sum(krow, smem + lay.lut + h * m * 16, mh, vec);
          s[h] = __fadd_rn(__fmul_rn(sc[h], static_cast<float>(a)), bi[h]);
        } else {
          s[h] = row_sum_f32(
              krow, reinterpret_cast<const float*>(smem + lay.lut) + h * m * 16,
              mh);
        }
        if (scores) scores[(bk * g + h) * smax + t0 + tid] = s[h];
      }
      const uint8_t* vrow = v_codes + row;
      if (vec == 8) {
        for (int j = 0; j < mh; j += 8)
          *reinterpret_cast<uint2*>(vcs + tid * mh + j) =
              *reinterpret_cast<const uint2*>(vrow + j);
      } else {
        for (int j = 0; j < mh; ++j) vcs[tid * mh + j] = vrow[j];
      }
    } else {
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) s[h] = -INFINITY;
    }
    // the tile's max per head
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h >= g) break;
      const float v = warp_max(s[h]);
      if (lane == 0) red[warp * g + h] = v;
    }
    __syncthreads();
    float msafe[kMaxG], corr[kMaxG];
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      msafe[h] = 0.f;
      corr[h] = 0.f;
      if (h >= g) continue;
      float tm = red[h];
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red[w * g + h]);
      const float mnew = fmaxf(mrun[h], tm);
      msafe[h] = isfinite(mnew) ? mnew : 0.f;
      corr[h] = isfinite(mrun[h]) ? expf(mrun[h] - msafe[h]) : 0.f;
      mrun[h] = mnew;
    }
    __syncthreads();  // red is reused for the sums
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h >= g) break;
      const float p = tid < n ? expf(s[h] - msafe[h]) : 0.f;
      ps[tid * g + h] = round_to<CB>(p);
      const float w = warp_sum(p);
      if (lane == 0) red[warp * g + h] = w;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h >= g) break;
      float ts = 0.f;
      for (int w = 0; w < kWarps; ++w) ts += red[w * g + h];
      lrun[h] = lrun[h] * corr[h] + ts;
    }
    if (grp < groups) {
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) acc[h] *= corr[h];
      for (int i = grp; i < n; i += groups) {
        const uint32_t byte = vcs[i * mh + (msub >> 1)];
        const uint32_t code = (msub & 1) ? (byte >> 4) : (byte & 15u);
        const float val = cbs[(msub * 16 + code) * dsub + dd];
#pragma unroll
        for (int h = 0; h < kMaxG; ++h) {
          if (h >= g) break;
          acc[h] = fmaf(ps[i * g + h], val, acc[h]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites vcs, ps and red
  }

  // the position groups' sums, added in group order
  if (grp < groups) {
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h >= g) break;
      red[(grp * g + h) * hd + d] = acc[h];
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int h = 0; h < kMaxG; ++h)
      if (h < g) lsum[h] = lrun[h];
  }
  __syncthreads();
  for (int i = tid; i < g * hd; i += kThreads) {
    const int h = i / hd, e = i % hd;
    float a = 0.f;
    for (int gr = 0; gr < groups; ++gr) a += red[(gr * g + h) * hd + e];
    out[(bk * g + h) * hd + e] = from_float<OUT>(a / fmaxf(lsum[h], 1e-20f));
  }
}

template <typename CB, typename OUT, bool Q8>
cudaError_t launch(const void* table, const float* scale, const float* bias,
                   const uint8_t* k_codes, const uint8_t* v_codes,
                   const void* v_cb, const int32_t* position, int b, int kv,
                   int g, int m, int dsub, int smax, void* out, float* scores,
                   cudaStream_t stream) {
  const size_t smem = layout(g, m, m * dsub, Q8).total;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto* kernel = pq_decode_kernel<CB, OUT, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the rows are mh bytes at multiples of mh: k_codes and v_codes alike
  const int vec = std::min(load_width(k_codes, m / 2),
                           load_width(v_codes, m / 2));
  kernel<<<b * kv, kThreads, smem, stream>>>(
      table, scale, bias, k_codes, v_codes, static_cast<const CB*>(v_cb),
      position, kv, g, m, dsub, smax, vec, static_cast<OUT*>(out), scores);
  return cudaGetLastError();
}

template <typename CB, typename OUT>
cudaError_t launch_q8(bool q8, const void* table, const float* scale,
                      const float* bias, const uint8_t* k_codes,
                      const uint8_t* v_codes, const void* v_cb,
                      const int32_t* position, int b, int kv, int g, int m,
                      int dsub, int smax, void* out, float* scores,
                      cudaStream_t stream) {
  return q8 ? launch<CB, OUT, true>(table, scale, bias, k_codes, v_codes,
                                    v_cb, position, b, kv, g, m, dsub, smax,
                                    out, scores, stream)
            : launch<CB, OUT, false>(table, scale, bias, k_codes, v_codes,
                                     v_cb, position, b, kv, g, m, dsub, smax,
                                     out, scores, stream);
}

}  // namespace

// Shared memory (bytes) one CTA needs at (g, M, head_dim, quantize_q8):
// the wrapper checks it against the card's limit before launching.
extern "C" long long repro_pq_decode_attention_smem(int g, int m, int hd,
                                                    int q8) {
  return static_cast<long long>(layout(g, m, hd, q8 != 0).total);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// table: (B, KV, g, M, 16) u8 with scale and summed bias (B, KV, g) f32
// when q8, else f32 (scale and bias unused); k_codes, v_codes: (B, Smax,
// KV, M/2) u8; v_cb: (KV, M, 16, dsub) bf16 or f32; position: (B,) i32;
// out: (B, KV * g, M * dsub) bf16 or f32; scores: null, or (B, KV, g,
// Smax) f32 that gets each live position's score.
extern "C" int repro_pq_decode_attention(
    const void* table, const void* scale, const void* bias,
    const void* k_codes, const void* v_codes, const void* v_cb,
    const void* position, int b, int kv, int g, int m, int dsub, int smax,
    int q8, int cb_bf16, int out_bf16, void* out, void* scores,
    void* stream) {
  if (g < 1 || g > kMaxG || m < 2 || m % 2 || dsub < 1 ||
      m * dsub > kThreads || b < 1 || kv < 1 || smax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* kc = static_cast<const uint8_t*>(k_codes);
  const auto* vc = static_cast<const uint8_t*>(v_codes);
  const auto* pos = static_cast<const int32_t*>(position);
  auto* sco = static_cast<float*>(scores);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cb_bf16 && out_bf16)
    err = launch_q8<__nv_bfloat16, __nv_bfloat16>(
        q8, table, sc, bi, kc, vc, v_cb, pos, b, kv, g, m, dsub, smax, out,
        sco, s);
  else if (cb_bf16)
    err = launch_q8<__nv_bfloat16, float>(q8, table, sc, bi, kc, vc, v_cb,
                                          pos, b, kv, g, m, dsub, smax, out,
                                          sco, s);
  else if (out_bf16)
    err = launch_q8<float, __nv_bfloat16>(q8, table, sc, bi, kc, vc, v_cb,
                                          pos, b, kv, g, m, dsub, smax, out,
                                          sco, s);
  else
    err = launch_q8<float, float>(q8, table, sc, bi, kc, vc, v_cb, pos, b,
                                  kv, g, m, dsub, smax, out, sco, s);
  return static_cast<int>(err);
}
