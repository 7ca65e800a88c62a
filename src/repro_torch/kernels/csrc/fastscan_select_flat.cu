// K7a: flat 4-bit ADC over one shared code database, the paper-faithful
// register-shuffle formulation, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_select_tree (Pallas body _select_tree_kernel, select tree
// _select_tree_acc). Computes exactly what that kernel computes:
//   out[q, n] = sum_m LUT[q, m, nibble_m(codes[n])]   (int32)
// for (Q, M, 16) u8 tables and (N, M/2) u8 nibble-packed codes, any Q and
// N (the reference pads N to its tile; rows past N are masked here).
//
// Bound on the H100: memory in principle -- the (Q, N) i32 output is ~98%
// of the bytes (512 MB at Q=128, N=1M, M=16, against 8 MB of codes) -- but
// a look-up done one row at a time costs ~6 integer instructions (byte
// extract, nibble mask, two byte permutes, a bit-3 select, a mask and an
// add), so such a scan is bound by its integer instructions instead.
//
// Design: one byte permute looks up FOUR rows of one sub-space, as the
// paper's vqtbl1q_u8 looks up 16 codes at once.
//   - The look-up (load_rows4, selectors4, sum_rows4 in
//     fastscan_common.cuh, shared with K1): a 16-bit selector of four
//     rows' low code bits and a byte mask of their bit 3 feed two prmt and
//     one lop3; two more prmt split even and odd rows into 16-bit lanes
//     (the register path takes M <= 32, so a sum is at most 8,160 and no
//     carry crosses lanes): 7 instructions per four look-ups.
//   - A thread owns four consecutive rows. It loads their codes once and
//     builds the selector and mask of each sub-space once per tile, in
//     registers (no other thread reads them), then walks the CTA's
//     kQueries queries over them, each query's LUT read from shared memory
//     as one broadcast 16-byte load per sub-space.
//   - Each thread stores its four sums as one 16-byte int4, consecutive
//     threads on consecutive rows, so the output stays coalesced (scalar
//     stores where N is not a multiple of 4 or at the last rows).
// The register path is templated on M/2 in {1, 2, 3, 4, 6, 8, 12, 16}; any
// other M stages the code tile in shared memory and reads the LUT there
// (row_sum in fastscan_common.cuh), which computes the same sums.
#include "fastscan_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 4 * kThreads;  // code rows a CTA scans
constexpr int kQueries = 16;             // queries a CTA walks over its tile

// Shared memory one CTA needs: its queries' (M, 16) LUTs, and on the
// shared-memory path its code tile.
size_t smem_bytes(int m) {
  return static_cast<size_t>(kQueries) * m * 16 +
         (repro_cuda::four_row_path(m / 2)
              ? 0
              : static_cast<size_t>(kTileRows) * (m / 2));
}

// Four consecutive rows per thread; vec (16, 4 or 1): the widest load the
// codes pointer's alignment allows.
template <int MH>
__global__ void __launch_bounds__(kThreads) select_flat_kernel(
    const uint8_t* __restrict__ table,  // (Q, M, 16)
    const uint8_t* __restrict__ codes,  // (N, M/2)
    int q, int n, int n_tiles, int vec,
    int32_t* __restrict__ out) {        // (Q, N)
  constexpr int M = 2 * MH;
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = blockIdx.x % n_tiles;
  const int q0 = (blockIdx.x / n_tiles) * kQueries;
  const int nq = min(kQueries, q - q0);
  repro_cuda::stage_bytes(smem, table + static_cast<size_t>(q0) * M * 16,
                          static_cast<size_t>(nq) * M * 16);
  __syncthreads();
  const long long row = static_cast<long long>(t) * kTileRows +
                        4 * static_cast<long long>(threadIdx.x);
  const int rows = static_cast<int>(min(4LL, n - row));
  if (rows <= 0) return;

  // the four rows' codes, then each sub-space's selector and bit-3 mask
  uint32_t cw[MH];
  repro_cuda::load_rows4<MH>(codes + row * MH, rows, vec, cw);
  uint32_t sel[M], msk[M];
  repro_cuda::selectors4<MH>(cw, sel, msk);

  const bool vec_out = (n & 3) == 0 && rows == 4;
  for (int qi = 0; qi < nq; ++qi) {
    const int4 sums = repro_cuda::sum_rows4<M>(
        reinterpret_cast<const uint4*>(smem) + qi * M, sel, msk);
    int32_t* dst = out + static_cast<size_t>(q0 + qi) * n + row;
    if (vec_out) {
      *reinterpret_cast<int4*>(dst) = sums;
    } else {
      dst[0] = sums.x;
      if (rows > 1) dst[1] = sums.y;
      if (rows > 2) dst[2] = sums.z;
      if (rows > 3) dst[3] = sums.w;
    }
  }
}

// Any M: the code tile staged in shared memory, the LUT read there.
__global__ void __launch_bounds__(kThreads) select_flat_smem_kernel(
    const uint8_t* __restrict__ table,  // (Q, M, 16)
    const uint8_t* __restrict__ codes,  // (N, M/2)
    int q, int m, int n, int n_tiles,
    int32_t* __restrict__ out) {        // (Q, N)
  extern __shared__ __align__(16) uint8_t smem[];
  const int mh = m / 2;
  uint8_t* luts = smem;  // (kQueries, M, 16)
  uint8_t* tile = smem + static_cast<size_t>(kQueries) * m * 16;  // (., M/2)
  const int t = blockIdx.x % n_tiles;
  const int q0 = (blockIdx.x / n_tiles) * kQueries;
  const int nq = min(kQueries, q - q0);
  const size_t row0 = static_cast<size_t>(t) * kTileRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kTileRows),
                                        static_cast<long long>(n) - row0));
  repro_cuda::stage_bytes(luts, table + static_cast<size_t>(q0) * m * 16,
                          static_cast<size_t>(nq) * m * 16);
  repro_cuda::stage_bytes(tile, codes + row0 * mh,
                          static_cast<size_t>(rows) * mh);
  __syncthreads();
  // rows start at multiples of mh bytes of a 16-byte aligned tile
  const int vec = (mh % 8 == 0) ? 8 : (mh % 4 == 0) ? 4 : 1;
  for (int qi = 0; qi < nq; ++qi) {
    const uint8_t* lut_bytes = luts + static_cast<size_t>(qi) * m * 16;
    int32_t* dst = out + static_cast<size_t>(q0 + qi) * n + row0;
    for (int r = threadIdx.x; r < rows; r += kThreads)
      dst[r] = repro_cuda::row_sum(tile + static_cast<size_t>(r) * mh,
                                   lut_bytes, mh, vec);
  }
}

// Grid and shared memory of one launch; false when the grid is too large.
bool shape(int q, int m, int n, int& n_tiles, unsigned& blocks, size_t& smem) {
  n_tiles = (n + kTileRows - 1) / kTileRows;
  const long long b =
      static_cast<long long>(n_tiles) * ((q + kQueries - 1) / kQueries);
  blocks = static_cast<unsigned>(b);
  smem = smem_bytes(m);
  return b < (1LL << 31);
}

template <int MH>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int q, int n,
                   int32_t* out, cudaStream_t stream) {
  int n_tiles;
  unsigned blocks;
  size_t smem;
  if (!shape(q, 2 * MH, n, n_tiles, blocks, smem))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      select_flat_kernel<MH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes);
  const int vec = (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 1;
  select_flat_kernel<MH><<<blocks, kThreads, smem, stream>>>(
      table, codes, q, n, n_tiles, vec, out);
  return cudaGetLastError();
}

cudaError_t launch_smem(const uint8_t* table, const uint8_t* codes, int q,
                        int m, int n, int32_t* out, cudaStream_t stream) {
  int n_tiles;
  unsigned blocks;
  size_t smem;
  if (!shape(q, m, n, n_tiles, blocks, smem))
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      select_flat_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  select_flat_smem_kernel<<<blocks, kThreads, smem, stream>>>(
      table, codes, q, m, n, n_tiles, out);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA needs at M sub-spaces: the wrapper checks
// it against the card's limit before launching.
extern "C" long long repro_fastscan_select_flat_smem(int m) {
  return static_cast<long long>(smem_bytes(m));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_select_flat(const void* table, const void* codes,
                                          int q, int m, int n, void* out,
                                          void* stream) {
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (m / 2) {
    case 1: err = launch<1>(t, c, q, n, o, s); break;
    case 2: err = launch<2>(t, c, q, n, o, s); break;
    case 3: err = launch<3>(t, c, q, n, o, s); break;
    case 4: err = launch<4>(t, c, q, n, o, s); break;
    case 6: err = launch<6>(t, c, q, n, o, s); break;
    case 8: err = launch<8>(t, c, q, n, o, s); break;
    case 12: err = launch<12>(t, c, q, n, o, s); break;
    case 16: err = launch<16>(t, c, q, n, o, s); break;
    default: err = launch_smem(t, c, q, m, n, o, s); break;
  }
  return static_cast<int>(err);
}
