// K5: grouped 4-bit ADC over a gathered copy of the probed lists, the
// paper-faithful register-shuffle formulation, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_select_tree_grouped (Pallas body _select_tree_grouped_kernel,
// select tree _select_tree_acc). Computes exactly what that kernel
// computes:
//   out[g, n] = sum_m LUT[g, m, nibble_m(codes[g, n])]   (int32)
// over a gathered (G, N, M/2) u8 copy whose N is a multiple of the tile.
//
// The look-up: each thread holds every sub-space's 16-entry u8 LUT row in
// registers as four 32-bit words. A 4-bit code c picks its byte with two
// byte permutes (prmt, __byte_perm) over the 8-byte halves, selecting byte
// c & 7 of {w1:w0} and of {w3:w2}, then a select on bit 3 -- the Hopper
// analogue of the paper's two 128-bit vqtbl1q_u8 shuffles, and of the
// reference's 4-level select tree. At M=16 the LUT is 64 registers a
// thread. The register form is compiled for M/2 in {1, 2, 3, 4, 6, 8, 12,
// 16}; any other M reads the LUT from shared memory (row_sum of
// fastscan_common.cuh), which computes the same sums.
//
// Bound on the H100: memory. The gathered copy is read once (M/2 bytes a
// row) and (N,) i32 sums are written once per group.
//
// Design (first version): one CTA per (group, tile), one row per thread
// per pass. The register LUT read (lookup, select_row) lives in
// fastscan_common.cuh.
#include "fastscan_common.cuh"

namespace {

constexpr int kThreads = 256;

// MH > 0: LUT in registers; MH == 0: any M, LUT read from shared memory.
template <int MH>
__global__ void __launch_bounds__(kThreads) select_grouped_kernel(
    const uint8_t* __restrict__ table,  // (G, M, 16)
    const uint8_t* __restrict__ codes,  // (G, N, M/2), gathered
    int m, int n, int tile_n, int n_tiles, int vec,
    int32_t* __restrict__ out) {        // (G, N)
  extern __shared__ uint32_t lut_words[];  // (M, 4): the LUT as words
  const int g = blockIdx.x / n_tiles;
  const int t = blockIdx.x - g * n_tiles;
  const int mh = m / 2;
  const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
  uint8_t* lut_bytes = reinterpret_cast<uint8_t*>(lut_words);
  for (int i = threadIdx.x; i < m * 16; i += blockDim.x) lut_bytes[i] = tab[i];
  __syncthreads();
  const size_t row0 = static_cast<size_t>(g) * n + static_cast<size_t>(t) * tile_n;
  const uint8_t* rows = codes + row0 * mh;
  int32_t* dst = out + row0;
  if constexpr (MH > 0) {
    uint32_t lut[2 * MH][4];
#pragma unroll
    for (int s = 0; s < 2 * MH; ++s) {
#pragma unroll
      for (int k = 0; k < 4; ++k) lut[s][k] = lut_words[s * 4 + k];
    }
    for (int r = threadIdx.x; r < tile_n; r += blockDim.x)
      dst[r] = repro_cuda::select_row<MH>(
          rows + static_cast<size_t>(r) * MH, lut, vec);
  } else {
    for (int r = threadIdx.x; r < tile_n; r += blockDim.x)
      dst[r] = repro_cuda::row_sum(rows + static_cast<size_t>(r) * mh,
                                   lut_bytes, mh, vec);
  }
}

template <int MH>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int g, int m,
                   int n, int tile_n, int vec, int32_t* out,
                   cudaStream_t stream) {
  const int n_tiles = n / tile_n;
  const size_t smem = static_cast<size_t>(m) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      select_grouped_kernel<MH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  select_grouped_kernel<MH><<<g * n_tiles, kThreads, smem, stream>>>(
      table, codes, m, n, tile_n, n_tiles, vec, out);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_select_grouped(const void* table,
                                             const void* codes, int g, int m,
                                             int n, int tile_n, void* out,
                                             void* stream) {
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  const int vec = repro_cuda::load_width(codes, m / 2);
  cudaError_t err;
  switch (m / 2) {
    case 1: err = launch<1>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 2: err = launch<2>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 3: err = launch<3>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 4: err = launch<4>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 6: err = launch<6>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 8: err = launch<8>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 12: err = launch<12>(t, c, g, m, n, tile_n, vec, o, s); break;
    case 16: err = launch<16>(t, c, g, m, n, tile_n, vec, o, s); break;
    default: err = launch<0>(t, c, g, m, n, tile_n, vec, o, s); break;
  }
  return static_cast<int>(err);
}
