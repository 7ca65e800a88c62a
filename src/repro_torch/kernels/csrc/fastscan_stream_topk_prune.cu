// K4: K1 with anytime early exit (tile pruning), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_stream_topk_grouped with early_exit=True (Pallas body
// _stream_topk_prune_kernel, merge _merge_smallest). Computes exactly what
// that kernel computes. For each query q (groups q*gpq .. q*gpq+gpq-1,
// query-major) its gpq*n_tiles (group, tile) steps run in flat order with a
// running top-kc of dequantized distances, run (all +inf at the start):
//   thr = run[kc-1];
//   a step is scanned iff probes[g] >= 0 and bounds[g] < thr; then
//     it emits K1's tile top-kc (vals, slots) and skipped = 0, and
//     d[i] = scale[g] * float(val[i]) + bias[g]   (+inf where slot < 0)
//     run = smallest kc of (run ++ d);
//   otherwise it reads nothing, emits ACC_SENTINEL / -1 and
//     skipped = (probes[g] >= 0).
// The reference's gated copy schedule (double_buffered_dma_gated) only
// saves copies; its compute-time check above alone decides the outputs.
//
// Why one CTA per query: the threshold tightens step by step, so which
// tiles are skipped depends on the flat step order. A CUDA grid has no
// order, so each query's steps run in order inside one CTA, with the
// block's threads parallel inside a tile. Q=1 is one CTA.
//
// Rounding: the dequantization is __fmul_rn then __fadd_rn, never an FMA,
// so the threshold rounds exactly as the host's two-op dequantization in
// core/ivf.py::scan_probes_stream and the skip decisions match the
// reference's.
//
// Bound on the H100: memory for the tiles it scans (M/2 bytes a row), as
// K1; each scanned step adds a bitonic sort of the tile's keys and one of
// the 2*kc merge buffer, which this first version does not hide.
#include <math_constants.h>

#include "fastscan_common.cuh"

namespace {

using repro_cuda::kAccSentinel;
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) stream_topk_prune_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    const int32_t* __restrict__ sizes,   // (nlist,)
    const uint8_t* __restrict__ fbits,   // (nlist, W) or null
    const float* __restrict__ bounds,    // (G,)
    const float* __restrict__ scales,    // (G,)
    const float* __restrict__ biases,    // (G,)
    int m, int cap, int w, int tile_n, int n_tiles, int kc, int gpq,
    int pow2, int mpow2, int vec, int32_t* __restrict__ out_vals,
    int32_t* __restrict__ out_slots, int32_t* __restrict__ out_skipped) {
  // pow2 tile keys, mpow2 merge buffer, kc running distances, then the LUT
  extern __shared__ unsigned long long keys[];
  float* mbuf = reinterpret_cast<float*>(keys + pow2);
  float* run = mbuf + mpow2;
  uint8_t* lut = reinterpret_cast<uint8_t*>(run + kc);

  const int q = blockIdx.x;
  const int mh = m / 2;
  for (int i = threadIdx.x; i < kc; i += blockDim.x) run[i] = CUDART_INF_F;
  __syncthreads();

  const int steps = gpq * n_tiles;
  for (int s = 0; s < steps; ++s) {
    const int g = q * gpq + s / n_tiles;
    const int t = s - (s / n_tiles) * n_tiles;
    const size_t tile_out = static_cast<size_t>(g) * n_tiles + t;
    const size_t out0 = tile_out * kc;
    const int lid = probes[g];
    // every thread reads the same threshold: the decision is block-uniform
    if (!(lid >= 0 && bounds[g] < run[kc - 1])) {
      for (int i = threadIdx.x; i < kc; i += blockDim.x) {
        out_vals[out0 + i] = kAccSentinel;
        out_slots[out0 + i] = -1;
      }
      if (threadIdx.x == 0) out_skipped[tile_out] = lid >= 0 ? 1 : 0;
      continue;
    }

    const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
    for (int i = threadIdx.x; i < m * 16; i += blockDim.x) lut[i] = tab[i];
    __syncthreads();
    const int size = sizes[lid];
    const int slot0 = t * tile_n;
    const uint8_t* list = codes + static_cast<size_t>(lid) * cap * mh;
    const uint8_t* fb = fbits ? fbits + static_cast<size_t>(lid) * w : nullptr;
    for (int r = threadIdx.x; r < pow2; r += blockDim.x) {
      unsigned long long key = ~0ull;
      if (r < tile_n) {
        const int slot = slot0 + r;
        int32_t val = kAccSentinel;
        bool live = slot < size;
        if (live && fb) live = (fb[slot >> 3] >> (slot & 7)) & 1;
        if (live)
          val = repro_cuda::row_sum(list + static_cast<size_t>(slot) * mh,
                                    lut, mh, vec);
        key = repro_cuda::slot_key(val, slot);
      }
      keys[r] = key;
    }
    repro_cuda::bitonic_sort(keys, pow2);

    const float scale = scales[g], bias = biases[g];
    for (int i = threadIdx.x; i < mpow2; i += blockDim.x) {
      float d = CUDART_INF_F;
      if (i < kc) {
        d = run[i];
      } else if (i < 2 * kc) {
        const unsigned long long key = keys[i - kc];
        const int32_t val = static_cast<int32_t>(key >> 32);
        const int32_t slot =
            val == kAccSentinel ? -1 : static_cast<int32_t>(key & 0xffffffffu);
        out_vals[out0 + i - kc] = val;
        out_slots[out0 + i - kc] = slot;
        if (slot >= 0)
          d = __fadd_rn(__fmul_rn(scale, static_cast<float>(val)), bias);
      }
      mbuf[i] = d;
    }
    if (threadIdx.x == 0) out_skipped[tile_out] = 0;
    repro_cuda::bitonic_sort(mbuf, mpow2);
    for (int i = threadIdx.x; i < kc; i += blockDim.x) run[i] = mbuf[i];
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_stream_topk_prune(
    const void* table, const void* codes, const void* probes,
    const void* sizes, const void* fbits, const void* bounds,
    const void* scales, const void* biases, int g, int m, int cap, int w,
    int tile_n, int kc, int gpq, void* out_vals, void* out_slots,
    void* out_skipped, void* stream) {
  const int n_tiles = cap / tile_n;
  const int pow2 = repro_cuda::next_pow2(tile_n);
  const int mpow2 = repro_cuda::next_pow2(2 * kc);
  const size_t smem = static_cast<size_t>(pow2) * 8 +
                      static_cast<size_t>(mpow2 + kc) * 4 +
                      static_cast<size_t>(m) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_topk_prune_kernel<<<g / gpq, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(sizes),
      static_cast<const uint8_t*>(fbits), static_cast<const float*>(bounds),
      static_cast<const float*>(scales), static_cast<const float*>(biases), m,
      cap, w, tile_n, n_tiles, kc, gpq, pow2, mpow2,
      repro_cuda::load_width(codes, m / 2), static_cast<int32_t*>(out_vals),
      static_cast<int32_t*>(out_slots), static_cast<int32_t*>(out_skipped));
  return static_cast<int>(cudaGetLastError());
}
