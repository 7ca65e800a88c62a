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
// card's operations-per-byte balance.
//
// Design (first version, simple on purpose; a later PR makes it fast):
//   - one CTA per (group, tile); the TPU's sequential grid carried no state
//     across tiles without early exit, so Hopper's independent blocks need
//     none either;
//   - the group's (M, 16) u8 LUT is staged in shared memory;
//   - each thread scans rows of the tile straight from the in-place store,
//     with 8- or 4-byte loads where the row is aligned;
//   - the filter bitmap is read in place, (nlist, W) u8 by list id;
//   - selection: every row becomes the 64-bit key (u32(val) << 32) | slot,
//     whose ascending order IS the reference's lowest-slot-wins order; the
//     tile's keys (padded to a power of two with UINT64_MAX) are sorted by
//     a shared-memory bitonic sort and the first kc are emitted.
// The row sum, the key and the sort live in fastscan_common.cuh, shared
// with K3, K4 and K5.
// The tile may be any size whose keys fit the block's shared memory; the
// host wrapper raises on a larger one.
#include "fastscan_common.cuh"

namespace {

using repro_cuda::kAccSentinel;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stream_topk_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    const int32_t* __restrict__ sizes,   // (nlist,)
    const uint8_t* __restrict__ fbits,   // (nlist, W) or null
    int m, int cap, int w, int tile_n, int n_tiles, int kc, int pow2,
    int vec, int32_t* __restrict__ out_vals, int32_t* __restrict__ out_slots) {
  extern __shared__ unsigned long long keys[];  // pow2 keys, then the LUT
  uint8_t* lut = reinterpret_cast<uint8_t*>(keys + pow2);

  const int g = blockIdx.x / n_tiles;
  const int t = blockIdx.x - g * n_tiles;
  const size_t out0 = (static_cast<size_t>(g) * n_tiles + t) * kc;
  const int lid = probes[g];
  if (lid < 0) {
    for (int i = threadIdx.x; i < kc; i += blockDim.x) {
      out_vals[out0 + i] = kAccSentinel;
      out_slots[out0 + i] = -1;
    }
    return;
  }

  const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
  for (int i = threadIdx.x; i < m * 16; i += blockDim.x) lut[i] = tab[i];
  __syncthreads();

  const int mh = m / 2;
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
      if (live) {
        val = repro_cuda::row_sum(list + static_cast<size_t>(slot) * mh, lut,
                                  mh, vec);
      }
      key = repro_cuda::slot_key(val, slot);
    }
    keys[r] = key;
  }
  repro_cuda::bitonic_sort(keys, pow2);

  for (int i = threadIdx.x; i < kc; i += blockDim.x) {
    const unsigned long long key = keys[i];
    const int32_t val = static_cast<int32_t>(key >> 32);
    out_vals[out0 + i] = val;
    out_slots[out0 + i] =
        val == kAccSentinel ? -1 : static_cast<int32_t>(key & 0xffffffffu);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_stream_topk(
    const void* table, const void* codes, const void* probes,
    const void* sizes, const void* fbits, int g, int m, int cap, int w,
    int tile_n, int kc, void* out_vals, void* out_slots, void* stream) {
  const int n_tiles = cap / tile_n;
  const int pow2 = repro_cuda::next_pow2(tile_n);
  const size_t smem = static_cast<size_t>(pow2) * 8 + static_cast<size_t>(m) * 16;
  const int vec = repro_cuda::load_width(codes, m / 2);
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_topk_kernel<<<g * n_tiles, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(sizes),
      static_cast<const uint8_t*>(fbits), m, cap, w, tile_n, n_tiles, kc, pow2,
      vec, static_cast<int32_t*>(out_vals), static_cast<int32_t*>(out_slots));
  return static_cast<int>(cudaGetLastError());
}
