// K1: gather-free grouped 4-bit ADC with fused per-tile top-kc, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_stream_topk_grouped with early_exit=False (Pallas body
// _stream_topk_kernel, selection _tile_topk). Computes exactly what that
// kernel computes:
//   for each group g (one query x probed list) and each cap tile t:
//     acc[row] = sum_m LUT[g, m, nibble_m(code[lid, slot])]        (int32)
//     acc[row] = ACC_SENTINEL where slot >= sizes[lid] or the row's
//                filter bit is 0
//     emit the kc smallest (acc, slot) pairs ascending, lowest slot first
//     among equal values, slot -1 where the value is ACC_SENTINEL;
//   an invalid probe (id < 0) emits ACC_SENTINEL / -1 and reads nothing.
//
// Bound on the H100: memory. Each probed list is read once (M/2 bytes a
// row, 8 at M=16) against M table look-ups and adds a row, far below the
// card's operations-per-byte balance. What a CTA pays instead is its chain
// of phases, so the design keeps that chain short:
//   - one CTA (8 warps) per (group, tile), with no state across tiles (the
//     TPU's sequential grid carried none without early exit); a tile with
//     no occupied slot, or an invalid probe, writes its sentinels and reads
//     nothing else;
//   - sums: each thread owns four consecutive rows and looks them up four
//     at a time with byte permutes (load_rows4 / selectors4 / sum_rows4 in
//     fastscan_common.cuh, as K7a) against the group's LUT, staged once in
//     shared memory and read as broadcast 16-byte words; M/2 outside the
//     four-row instantiations takes the shared-memory row_sum, one row at a
//     time;
//   - selection without sorting the tile: a live sum is an integer in
//     [0, M*255], so a shared-memory histogram of the sums (a radix select
//     over digits of at most 12 bits: one pass up to M = 16) finds v*, the
//     kc-th smallest value. A block scan in slot order then sends the rows
//     under v* to a candidate list and the first rows equal to v* straight
//     to their output places after them;
//   - the fewer than kc candidates are ranked: each one counts the
//     candidates that go before it in (value, slot) order, 8 lanes to a
//     candidate, and is written at its rank.
// Six block barriers a tile of at most 1024 rows at M <= 16.
#include "fastscan_common.cuh"

namespace {

using repro_cuda::kAccSentinel;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = 4 * kThreads;  // rows the block covers at a time
constexpr int kMaxDigitBits = 12;        // histogram bins a pass: <= 4096
constexpr int kMaxPer = (1 << kMaxDigitBits) / kThreads;  // bins a thread
constexpr int kRankLanes = 8;            // lanes counting for a candidate
constexpr size_t kScratch = 48;          // the select's result, warp totals
constexpr size_t kSmemLimit = 232448;    // dynamic shared memory of a block
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of a CTA's shared-memory regions: the tile's sums (four per
// thread, 16-byte aligned), the histogram, the candidates' values and
// slots, and the group's LUT (or none: read in place, for an M too large).
struct Layout {
  size_t vals, bins, cand_v, cand_s, lut, total;
};

__host__ __device__ inline Layout layout(int tile_n, int kc, int m,
                                         int digit_bits, bool lut_smem) {
  Layout l;
  l.vals = kScratch;
  l.bins = l.vals + align16(static_cast<size_t>(tile_n) * 4);
  l.cand_v = l.bins + align16((static_cast<size_t>(1) << digit_bits) * 4);
  l.cand_s = l.cand_v + align16(static_cast<size_t>(kc) * 4);
  l.lut = l.cand_s + align16(static_cast<size_t>(kc) * 4);
  l.total = l.lut + (lut_smem ? align16(static_cast<size_t>(m) * 16) : 0);
  return l;
}

// Bits of the largest live sum, M*255: the radix select's key width.
__host__ __device__ inline int sum_bits(int m) {
  int b = 0;
  while ((static_cast<long long>(m) * 255) >> b) ++b;
  return b;
}

struct Plan {
  bool lut_smem;
  int digit_bits;
  size_t smem;
};

// The LUT in shared memory at the widest digit that fits, then narrower
// digits, then the LUT read in place. smem > kSmemLimit: refused.
__host__ __device__ inline Plan plan(int tile_n, int kc, int m) {
  const int dmax = sum_bits(m) < kMaxDigitBits ? sum_bits(m) : kMaxDigitBits;
  Plan p{true, dmax, layout(tile_n, kc, m, dmax, true).total};
  for (int lut = 1; lut >= 0 && p.smem > kSmemLimit; --lut)
    for (int d = dmax; d >= 1 && p.smem > kSmemLimit; --d)
      p = Plan{lut == 1, d, layout(tile_n, kc, m, d, lut == 1).total};
  return p;
}

__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix of x over the block in thread order, and the block's
// total; one block barrier, and the caller's next one frees wtot.
__device__ __forceinline__ int block_excl_scan(int x, int* wtot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(x);
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  const int wt = lane < kWarps ? wtot[lane] : 0;
  const int wincl = warp_incl_scan(wt);
  total = __shfl_sync(kFull, wincl, 31);
  return __shfl_sync(kFull, wincl - wt, warp) + incl - x;
}

// Over the nb bins of one radix pass, finds the bin that holds the kth
// smallest counted row (1-based): writes (bin, rows in lower bins) to
// sel[0], sel[1] when the bins count at least kth rows, clears the bins
// and returns their total. Each thread owns nb/256 consecutive bins (read
// 16 bytes at a time when they are a multiple of 4). Two block barriers.
__device__ __forceinline__ int select_bin(int* bins, int nb, int kth,
                                          int* sel, int* wtot) {
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  int mine[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) mine[i] = 0;
  if (per % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kMaxPer; i += 4) {
      if (i < per) {
        int4* p = reinterpret_cast<int4*>(bins + b0 + i);
        const int4 v = *p;
        mine[i] = v.x;
        mine[i + 1] = v.y;
        mine[i + 2] = v.z;
        mine[i + 3] = v.w;
        *p = make_int4(0, 0, 0, 0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (i < per && b0 + i < nb) {
        mine[i] = bins[b0 + i];
        bins[b0 + i] = 0;
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) sum += mine[i];
  int total;
  int c = block_excl_scan(sum, wtot, total);
  if (c < kth && kth <= c + sum) {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (c < kth && c + mine[i] >= kth) {
        sel[0] = b0 + i;
        sel[1] = c;
      }
      c += mine[i];
    }
  }
  __syncthreads();
  return total;
}

// The sums of `rows` (1..4) consecutive rows from src into s; MH = 0: any
// M/2 (mh), one row_sum a row, with vec the per-row load width (8, 4, 1);
// else the four-row look-up, with vec the four rows' load width (16, 4, 1)
// and the LUT 16-byte aligned.
template <int MH>
__device__ __forceinline__ int4 sums4(const uint8_t* src, int rows,
                                      const uint8_t* lut, int mh, int vec) {
  if constexpr (MH > 0) {
    uint32_t cw[MH];
    repro_cuda::load_rows4<MH>(src, rows, vec, cw);
    uint32_t sel[2 * MH], msk[2 * MH];
    repro_cuda::selectors4<MH>(cw, sel, msk);
    return repro_cuda::sum_rows4<2 * MH>(reinterpret_cast<const uint4*>(lut),
                                         sel, msk);
  } else {
    int s[4] = {0, 0, 0, 0};
    for (int i = 0; i < rows; ++i)
      s[i] = repro_cuda::row_sum(src + static_cast<size_t>(i) * mh, lut, mh,
                                 vec);
    return make_int4(s[0], s[1], s[2], s[3]);
  }
}

__device__ __forceinline__ int lane_of(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int MH>
__global__ void __launch_bounds__(kThreads) stream_topk_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    const int32_t* __restrict__ sizes,   // (nlist,)
    const uint8_t* __restrict__ fbits,   // (nlist, W) or null
    int m, int cap, int w, int tile_n, int n_tiles, int kc, int digit_bits,
    int lut_smem, int vec, int32_t* __restrict__ out_vals,
    int32_t* __restrict__ out_slots) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(tile_n, kc, m, digit_bits, lut_smem != 0);
  int* sel = reinterpret_cast<int*>(smem);
  int* wtot = reinterpret_cast<int*>(smem + 16);
  int32_t* vals = reinterpret_cast<int32_t*>(smem + l.vals);
  int* bins = reinterpret_cast<int*>(smem + l.bins);
  int32_t* cand_v = reinterpret_cast<int32_t*>(smem + l.cand_v);
  int32_t* cand_s = reinterpret_cast<int32_t*>(smem + l.cand_s);

  const int tid = threadIdx.x;
  const int g = blockIdx.x / n_tiles;
  const int t = blockIdx.x - g * n_tiles;
  const size_t out0 = (static_cast<size_t>(g) * n_tiles + t) * kc;
  const int lid = probes[g];
  const int slot0 = t * tile_n;
  // occupied slots of the tile: rows [0, live)
  const int live = lid < 0 ? 0 : min(max(sizes[lid] - slot0, 0), tile_n);
  if (live == 0) {
    for (int i = tid; i < kc; i += kThreads) {
      out_vals[out0 + i] = kAccSentinel;
      out_slots[out0 + i] = -1;
    }
    return;
  }

  const int mh = m / 2;
  const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
  const uint8_t* lut = tab;
  if (lut_smem) {
    lut = smem + l.lut;
    repro_cuda::stage_bytes(smem + l.lut, tab, static_cast<size_t>(m) * 16);
  }
  const int bits = sum_bits(m);
  int rb = bits;
  int wd = min(digit_bits, rb);
  for (int i = tid; i < (1 << wd); i += kThreads) bins[i] = 0;
  __syncthreads();

  // 1. the sums of the occupied rows (sentinel where filtered out) and the
  //    first radix pass's histogram
  const uint8_t* list = codes + (static_cast<size_t>(lid) * cap + slot0) * mh;
  const uint8_t* fb = fbits ? fbits + static_cast<size_t>(lid) * w : nullptr;
  for (int r0 = 4 * tid; r0 < live; r0 += kPassRows) {
    const int rows = min(4, live - r0);
    const int4 s = sums4<MH>(list + static_cast<size_t>(r0) * mh, rows, lut,
                             mh, vec);
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int slot = slot0 + r0 + i;
      bool ok = i < rows;
      if (ok && fb) ok = (__ldg(fb + (slot >> 3)) >> (slot & 7)) & 1;
      v[i] = ok ? lane_of(s, i) : kAccSentinel;
      if (ok) atomicAdd(&bins[v[i] >> (rb - wd)], 1);
    }
    *reinterpret_cast<int4*>(vals + r0) = make_int4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // 2. radix select: v*, the kc-th smallest sum (ACC_SENTINEL when fewer
  //    than kc rows pass), and `below`, the rows under it
  int kth = kc, prefix = 0, below = 0, vstar;
  for (;;) {
    const int total = select_bin(bins, 1 << wd, kth, sel, wtot);
    if (total < kth) {  // first pass only: fewer than kc rows pass
      vstar = kAccSentinel;
      below = total;
      break;
    }
    prefix = (prefix << wd) | sel[0];
    below += sel[1];
    kth -= sel[1];
    rb -= wd;
    if (rb == 0) {
      vstar = prefix;
      break;
    }
    wd = min(digit_bits, rb);
    for (int r = tid; r < live; r += kThreads) {
      const int32_t v = vals[r];
      if (v != kAccSentinel && (v >> rb) == prefix)
        atomicAdd(&bins[(v >> (rb - wd)) & ((1 << wd) - 1)], 1);
    }
    __syncthreads();
  }

  // 3. in slot order (thread order, four rows a thread): the rows under v*
  //    to the candidates, the first kc - below rows equal to v* straight to
  //    outputs below .. kc - 1 (they follow every candidate)
  const bool take_eq = vstar != kAccSentinel;
  int carry_lt = 0, carry_eq = 0;
  for (int base = 0; base < live; base += kPassRows) {
    const int r0 = base + 4 * tid;
    const int4 v4 = r0 < live ? *reinterpret_cast<const int4*>(vals + r0)
                              : make_int4(0, 0, 0, 0);
    int v[4], x;
    unsigned lt = 0, eq = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = r0 + i < live ? lane_of(v4, i) : kAccSentinel;
      if (v[i] < vstar) lt |= 1u << i;
      if (take_eq && v[i] == vstar) eq |= 1u << i;
    }
    // a pass counts at most 1024 rows of each kind: 16 bits each
    x = __popc(lt) | (__popc(eq) << 16);
    int total;
    const int excl = block_excl_scan(x, wtot, total);
    int pl = carry_lt + (excl & 0xffff);
    int pe = below + carry_eq + (excl >> 16);
    carry_lt += total & 0xffff;
    carry_eq += total >> 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (lt >> i & 1) {
        cand_v[pl] = v[i];
        cand_s[pl] = slot0 + r0 + i;
        ++pl;
      }
      if (eq >> i & 1) {
        if (pe < kc) {
          out_vals[out0 + pe] = vstar;
          out_slots[out0 + pe] = slot0 + r0 + i;
        }
        ++pe;
      }
    }
    __syncthreads();  // the candidates are written, wtot is free
  }

  // 4. each candidate's rank: the candidates with a smaller value, or an
  //    equal value and a lower slot (= a lower index: they are in slot
  //    order), counted by 8 lanes an eighth each
  const int part = tid % kRankLanes;
  for (int e0 = 0; e0 < below; e0 += kThreads / kRankLanes) {
    const int e = e0 + tid / kRankLanes;
    int n = 0, v = 0;
    if (e < below) {
      v = cand_v[e];
      for (int j = part; j < below; j += kRankLanes) {
        const int y = cand_v[j];
        n += y < v || (y == v && j < e);
      }
    }
#pragma unroll
    for (int o = 1; o < kRankLanes; o <<= 1) n += __shfl_xor_sync(kFull, n, o);
    if (part == 0 && e < below) {
      out_vals[out0 + n] = v;
      out_slots[out0 + n] = cand_s[e];
    }
  }
  if (!take_eq) {
    for (int i = below + tid; i < kc; i += kThreads) {
      out_vals[out0 + i] = kAccSentinel;
      out_slots[out0 + i] = -1;
    }
  }
}

template <int MH>
cudaError_t launch(const uint8_t* table, const uint8_t* codes,
                   const int32_t* probes, const int32_t* sizes,
                   const uint8_t* fbits, int g, int m, int cap, int w,
                   int tile_n, int kc, const Plan& p, int vec,
                   int32_t* out_vals, int32_t* out_slots,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_kernel<MH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = cap / tile_n;
  stream_topk_kernel<MH><<<g * n_tiles, kThreads, p.smem, stream>>>(
      table, codes, probes, sizes, fbits, m, cap, w, tile_n, n_tiles, kc,
      p.digit_bits, p.lut_smem ? 1 : 0, vec, out_vals, out_slots);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory (bytes) one CTA needs at (tile_n, kc, M): the wrapper
// checks it against the card's limit before launching.
extern "C" long long repro_fastscan_stream_topk_smem(int tile_n, int kc,
                                                     int m) {
  return static_cast<long long>(plan(tile_n, kc, m).smem);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_stream_topk(
    const void* table, const void* codes, const void* probes,
    const void* sizes, const void* fbits, int g, int m, int cap, int w,
    int tile_n, int kc, void* out_vals, void* out_slots, void* stream) {
  const Plan p = plan(tile_n, kc, m);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int mh = m / 2;
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* pr = static_cast<const int32_t*>(probes);
  const auto* sz = static_cast<const int32_t*>(sizes);
  const auto* fb = static_cast<const uint8_t*>(fbits);
  auto* ov = static_cast<int32_t*>(out_vals);
  auto* os = static_cast<int32_t*>(out_slots);
  auto* s = static_cast<cudaStream_t>(stream);
  // the four-row look-up reads the staged LUT as 16-byte words, and its
  // four rows with the widest load every tile's start allows
  if (p.lut_smem && repro_cuda::four_row_path(mh)) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
    const long long lb = static_cast<long long>(cap) * mh;
    const long long tb = static_cast<long long>(tile_n) * mh;
    const int vec = (mh % 4 == 0 && a % 16 == 0 && lb % 16 == 0 &&
                     tb % 16 == 0)
                        ? 16
                    : (a % 4 == 0 && lb % 4 == 0 && tb % 4 == 0) ? 4
                                                                  : 1;
    cudaError_t err;
    switch (mh) {
#define K1_CASE(MH)                                                          \
  case MH:                                                                   \
    err = launch<MH>(t, c, pr, sz, fb, g, m, cap, w, tile_n, kc, p, vec, ov, \
                     os, s);                                                 \
    break;
      K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(6) K1_CASE(8)
      K1_CASE(12) K1_CASE(16)
#undef K1_CASE
      default:
        err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
  return static_cast<int>(launch<0>(t, c, pr, sz, fb, g, m, cap, w, tile_n,
                                    kc, p, repro_cuda::load_width(codes, mh),
                                    ov, os, s));
}
