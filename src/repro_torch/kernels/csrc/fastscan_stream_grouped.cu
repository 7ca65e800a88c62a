// K3: gather-free grouped 4-bit ADC over the list store in place, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_stream_grouped (Pallas body _stream_grouped_kernel). Computes
// exactly what that kernel computes:
//   out[g, slot] = sum_m LUT[g, m, nibble_m(code[probes[g], slot])]  (int32)
// for every slot of the list, with no occupancy mask (a padding slot holds
// the sum of LUT[g, m, 0]), and out[g, :] = 0 for a probe id < 0, whose
// list is never read.
//
// Bound on the H100: memory. Each probed tile is read once (M/2 bytes a
// row) and its (cap,) i32 row of sums is written once, against M table
// look-ups and adds a row.
//
// Design (first version, simple on purpose): one CTA per (group, tile);
// the group's (M, 16) u8 LUT is staged in shared memory and each thread
// sums rows of the tile straight from the store (fastscan_common.cuh's
// row sum, shared with K1).
#include "fastscan_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stream_grouped_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    int m, int cap, int tile_n, int n_tiles, int vec,
    int32_t* __restrict__ out) {         // (G, cap)
  extern __shared__ uint8_t lut[];       // (M, 16)
  const int g = blockIdx.x / n_tiles;
  const int t = blockIdx.x - g * n_tiles;
  const int slot0 = t * tile_n;
  int32_t* dst = out + static_cast<size_t>(g) * cap + slot0;
  const int lid = probes[g];
  if (lid < 0) {
    for (int r = threadIdx.x; r < tile_n; r += blockDim.x) dst[r] = 0;
    return;
  }
  const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
  for (int i = threadIdx.x; i < m * 16; i += blockDim.x) lut[i] = tab[i];
  __syncthreads();
  const int mh = m / 2;
  const uint8_t* rows =
      codes + (static_cast<size_t>(lid) * cap + slot0) * mh;
  for (int r = threadIdx.x; r < tile_n; r += blockDim.x)
    dst[r] = repro_cuda::row_sum(rows + static_cast<size_t>(r) * mh, lut, mh,
                                 vec);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_stream_grouped(
    const void* table, const void* codes, const void* probes, int g, int m,
    int cap, int tile_n, void* out, void* stream) {
  const int n_tiles = cap / tile_n;
  const size_t smem = static_cast<size_t>(m) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      stream_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_grouped_kernel<<<g * n_tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(probes), m, cap, tile_n, n_tiles,
      repro_cuda::load_width(codes, m / 2), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
