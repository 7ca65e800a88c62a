// K6: grouped 4-bit ADC as a one-hot matrix product on the tensor cores,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_onehot_mxu_grouped (Pallas body _onehot_mxu_grouped_kernel:
// the group's (1, M*16) LUT row contracted with one-hot code planes on the
// MXU). Computes the same function as K5:
//   out[g, n] = sum_m LUT[g, m, nibble_m(codes[g, n])]   (int32)
// over a gathered (G, N, M/2) u8 copy whose N is a multiple of the tile.
//
// Formulation: u8 x u8 -> s32 integer MMA (nvcuda::wmma, m16n16k16). For
// 16 rows at a time, one k-step is exactly one sub-space:
//   A (16 x 16 u8): A[r, j] = (nibble_m(row r) == j), the one-hot codes;
//   B (16 x 16 u8): column 0 = LUT[g, m, :], the other 15 columns zero;
// and C accumulates over the M sub-spaces; column 0 of C is the row sums.
// Exact: every product is u8 * {0, 1} and the s32 sums stay <= M * 255.
// Fifteen of B's sixteen columns are zero, so 15/16 of the MMA work is
// wasted; this first version accepts it to keep 'mxu' a tensor-core
// formulation distinct from K5's register shuffles.
//
// Bound on the H100: memory, as K5 (the useful work is M look-ups a row).
//
// Design: one CTA (8 warps) per (group, tile); the group's M B-tiles are
// built once in shared memory; each warp builds its 16-row A tile per
// sub-space in shared memory and issues one MMA per sub-space.
#include <mma.h>

#include "fastscan_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads) onehot_mma_grouped_kernel(
    const uint8_t* __restrict__ table,  // (G, M, 16)
    const uint8_t* __restrict__ codes,  // (G, N, M/2), gathered
    int m, int n, int tile_n, int n_tiles,
    int32_t* __restrict__ out) {        // (G, N)
  // M B-tiles (256 B each), then a 256 B A-tile and a 16x16 s32 C-tile per
  // warp; every tile starts on a 32-byte boundary, as wmma loads need
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* btiles = smem;
  uint8_t* atile = smem + static_cast<size_t>(m) * 256;
  int32_t* ctile = reinterpret_cast<int32_t*>(atile + kWarps * 256);

  const int g = blockIdx.x / n_tiles;
  const int t = blockIdx.x - g * n_tiles;
  const int mh = m / 2;
  const uint8_t* tab = table + static_cast<size_t>(g) * m * 16;
  // B for sub-space s, column-major: element (k, col) at col * 16 + k
  for (int i = threadIdx.x; i < m * 256; i += blockDim.x) {
    const int s = i >> 8, e = i & 255;
    btiles[i] = (e < 16) ? tab[s * 16 + e] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* a_mine = atile + warp * 256;
  int32_t* c_mine = ctile + warp * 256;
  const size_t row0 = static_cast<size_t>(g) * n + static_cast<size_t>(t) * tile_n;
  const int half = (lane & 1) * 8;  // this lane's 8 columns of its A row
  for (int r0 = warp * 16; r0 < tile_n; r0 += kWarps * 16) {
    const int r = r0 + (lane >> 1);   // this lane's A row
    const uint8_t* row = r < tile_n ? codes + (row0 + r) * mh : nullptr;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    for (int s = 0; s < m; ++s) {
      // one-hot of sub-space s; rows past the tile stay all zero
      const uint32_t code = row ? (row[s >> 1] >> (4 * (s & 1))) & 15u : 16u;
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= static_cast<uint32_t>(code == static_cast<uint32_t>(half + j)) << (8 * j);
        hi |= static_cast<uint32_t>(code == static_cast<uint32_t>(half + 4 + j)) << (8 * j);
      }
      *reinterpret_cast<uint2*>(a_mine + (lane >> 1) * 16 + half) = make_uint2(lo, hi);
      __syncwarp();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major> b;
      wmma::load_matrix_sync(a, a_mine, 16);
      wmma::load_matrix_sync(b, btiles + s * 256, 16);
      wmma::mma_sync(acc, a, b, acc);
      __syncwarp();
    }
    wmma::store_matrix_sync(c_mine, acc, 16, wmma::mem_row_major);
    __syncwarp();
    if (lane < 16 && r0 + lane < tile_n) out[row0 + r0 + lane] = c_mine[lane * 16];
    __syncwarp();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_onehot_mma_grouped(const void* table,
                                                 const void* codes, int g,
                                                 int m, int n, int tile_n,
                                                 void* out, void* stream) {
  const int n_tiles = n / tile_n;
  const size_t smem = static_cast<size_t>(m) * 256 + kWarps * (256 + 1024);
  cudaError_t err = cudaFuncSetAttribute(
      onehot_mma_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  onehot_mma_grouped_kernel<<<g * n_tiles, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(codes),
      m, n, tile_n, n_tiles, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
