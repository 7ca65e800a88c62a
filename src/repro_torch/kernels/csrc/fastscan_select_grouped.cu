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
// Bound on the H100: memory. The gathered copy is read once (M/2 bytes a
// row) and the (G, N) i32 sums are written once: 202 MB at G = N = 4096,
// M = 16, four times the L2.
//
// Design:
//   - The look-up is K1's and K7a's (selectors4, sum_rows4 in
//     fastscan_common.cuh): a thread owns quads of four consecutive rows;
//     for each it builds every sub-space's selector and bit-3 mask once
//     (a byte transpose, then ~10 instructions per code byte), reads the
//     group's LUT from shared memory as one broadcast 16-byte load a
//     sub-space, and sums the four rows with two prmt, one lop3, one prmt
//     and two adds (at M <= 32 a sum is at most 8,160, so 16-bit lanes
//     hold it). No LUT is held in registers. A quad's four sums leave as
//     one 16-byte streaming store, consecutive threads on consecutive
//     quads.
//   - Bytes in flight: persistent CTAs (as many as are resident) walk
//     (group, chunk of 4,096 rows) units, four quads a thread: four
//     independent look-ups keep the issue slots busy with 16 warps an SM.
//     A ring of three cp.async stages holds each unit's LUT (copied once
//     a unit, 16 bytes a copy) beside its code chunk, so two units' codes
//     (64 KB at M = 16) are in flight a CTA while one computes. Loads
//     issued by each thread ahead of its own compute would hold the codes
//     in registers instead; the ring leaves them to the look-up. One
//     barrier a unit.
//   - Units halve (down to 128 rows, with two quads a thread at 2,048 rows
//     and one below) while they would not give every SM two, so that a
//     launch over few groups (G = 32) still spreads.
//   - M/2 outside the four-row set {1, 2, 3, 4, 6, 8, 12, 16}: one CTA
//     per (group, 1,024 rows), the LUT staged with 16-byte copies and
//     read by row_sum from shared memory, which computes the same sums.
// The chunks do not depend on tile_n: every row of a group uses one LUT,
// so any split of the rows gives the same sums.
#include <algorithm>

#include "fastscan_mma_flat.cuh"  // cp.async staging, resident_ctas

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kMaxQuads = 4;  // quads of rows a thread in a full unit
constexpr int kUnitRows = 4 * kThreads * kMaxQuads;  // rows of a full unit
constexpr int kStages = 3;
constexpr int kSmemRows = 4 * kThreads;  // rows of a CTA at any other M

// Byte offsets of one ring stage: the unit's LUT, then its code chunk.
struct Layout {
  size_t lut, stage, total;
};

__host__ __device__ inline Layout layout(int m, int rows) {
  Layout l;
  l.lut = align16(16 * static_cast<size_t>(m));
  l.stage = l.lut + align16(static_cast<size_t>(rows) * (m / 2));
  l.total = kStages * l.stage;
  return l;
}

// Shared memory one CTA takes at M sub-spaces: the ring at full units on
// the four-row path, else the LUT (select_kernel.smem_bytes mirrors it).
__host__ __device__ inline size_t smem_bytes(int m) {
  return four_row_path(m / 2) ? layout(m, kUnitRows).total
                              : 16 * static_cast<size_t>(m);
}

// QUADS quads of rows a thread: units of up to 4 * kThreads * QUADS rows.
template <int MH, int QUADS>
__global__ void __launch_bounds__(kThreads) select_grouped_kernel(
    const uint8_t* __restrict__ table,  // (G, M, 16)
    const uint8_t* __restrict__ codes,  // (G, N, M/2), gathered
    int n, int unit_rows, int chunks, int n_units,
    int32_t* __restrict__ out) {        // (G, N)
  constexpr int M = 2 * MH;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(M, unit_rows);
  const int step = gridDim.x;

  auto load = [&](int u, int s) {
    const int grp = u / chunks;
    const int row0 = (u - grp * chunks) * unit_rows;
    uint8_t* dst = smem + s * l.stage;
    copy_async<kThreads>(dst, table + static_cast<size_t>(grp) * M * 16,
                         16 * M);
    copy_async<kThreads>(
        dst + l.lut, codes + (static_cast<size_t>(grp) * n + row0) * MH,
        static_cast<size_t>(min(unit_rows, n - row0)) * MH);
  };

  // the ring: unit i of this CTA (blockIdx.x + i * step) in stage i % 3
  for (int s = 0; s < kStages - 1; ++s) {
    const int u = blockIdx.x + s * step;
    if (u < n_units) load(u, s);
    cp_async_commit();
  }
  int i = 0;
  for (int u = blockIdx.x; u < n_units; u += step, ++i) {
    cp_async_wait<kStages - 2>();
    // unit i's LUT and codes are in, and every thread is done with the
    // stage of unit i - 1
    __syncthreads();
    const int nu = u + (kStages - 1) * step;
    if (nu < n_units) load(nu, (i + kStages - 1) % kStages);
    cp_async_commit();

    const int grp = u / chunks;
    const int row0 = (u - grp * chunks) * unit_rows;
    const int rows = min(unit_rows, n - row0);
    const uint8_t* st = smem + (i % kStages) * l.stage;
    const uint4* lut = reinterpret_cast<const uint4*>(st);
    // quad qd of the thread: rows r .. r + 3 of the unit, consecutive
    // threads on consecutive quads
#pragma unroll
    for (int qd = 0; qd < QUADS; ++qd) {
      const int r = 4 * (threadIdx.x + qd * kThreads);
      if (r >= rows) break;
      uint32_t cw[MH];
      stage_rows4<MH>(st + l.lut + static_cast<size_t>(r) * MH, cw);
      uint32_t sel[M], msk[M];
      selectors4<MH>(cw, sel, msk);
      const int4 sums = sum_rows4<M>(lut, sel, msk);
      const size_t o = static_cast<size_t>(grp) * n + row0 + r;
      int32_t* dst = out + o;
      if ((o & 3) == 0 && r + 4 <= rows) {  // out is 16-byte aligned
        __stcs(reinterpret_cast<int4*>(dst), sums);
      } else {
        __stcs(dst, sums.x);
        if (r + 1 < rows) __stcs(dst + 1, sums.y);
        if (r + 2 < rows) __stcs(dst + 2, sums.z);
        if (r + 3 < rows) __stcs(dst + 3, sums.w);
      }
    }
  }
}

// Any M: one CTA per (group, 1,024 rows), the LUT in shared memory.
__global__ void __launch_bounds__(kThreads) select_grouped_smem_kernel(
    const uint8_t* __restrict__ table,  // (G, M, 16)
    const uint8_t* __restrict__ codes,  // (G, N, M/2), gathered
    int m, int n, int chunks, int vec,
    int32_t* __restrict__ out) {        // (G, N)
  extern __shared__ __align__(16) uint8_t lut[];  // (M, 16)
  const int g = blockIdx.x / chunks;
  const int row0 = (blockIdx.x - g * chunks) * kSmemRows;
  const int rows = min(kSmemRows, n - row0);
  const int mh = m / 2;
  stage_bytes(lut, table + static_cast<size_t>(g) * m * 16,
              16 * static_cast<size_t>(m));
  __syncthreads();
  const size_t base = static_cast<size_t>(g) * n + row0;
  for (int r = threadIdx.x; r < rows; r += kThreads)
    out[base + r] = row_sum(codes + (base + r) * mh, lut, mh, vec);
}

template <int MH, int QUADS>
cudaError_t launch_walk(const uint8_t* table, const uint8_t* codes, int g,
                        int n, int rows, int32_t* out, cudaStream_t stream) {
  const Layout l = layout(2 * MH, rows);
  const auto kernel = select_grouped_kernel<MH, QUADS>;
  long long resident = 0;
  cudaError_t err = resident_ctas(kernel, kThreads, l.total, resident);
  if (err != cudaSuccess) return err;
  const int chunks = (n + rows - 1) / rows;
  const long long n_units = static_cast<long long>(g) * chunks;
  const long long grid = std::min(n_units, resident);
  // unit indices, and the prefetch's up to 2 grids past them, stay ints
  if (n_units + kStages * grid >= (1LL << 31))
    return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreads, l.total, stream>>>(
      table, codes, n, rows, chunks, static_cast<int>(n_units), out);
  return cudaGetLastError();
}

template <int MH>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int g, int n,
                   int32_t* out, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // fewer rows a unit where the units would not fill every SM twice, and
  // then one quad a thread
  int rows = kUnitRows;
  while (rows > 128 &&
         static_cast<long long>(g) * ((n + rows - 1) / rows) < 2LL * sms)
    rows /= 2;
  if (rows == kUnitRows)
    return launch_walk<MH, kMaxQuads>(table, codes, g, n, rows, out, stream);
  if (rows == kUnitRows / 2)
    return launch_walk<MH, kMaxQuads / 2>(table, codes, g, n, rows, out,
                                          stream);
  return launch_walk<MH, 1>(table, codes, g, n, rows, out, stream);
}

cudaError_t launch_smem(const uint8_t* table, const uint8_t* codes, int g,
                        int m, int n, int32_t* out, cudaStream_t stream) {
  const int chunks = (n + kSmemRows - 1) / kSmemRows;
  const long long blocks = static_cast<long long>(g) * chunks;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      select_grouped_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  select_grouped_smem_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(table, codes, m, n, chunks,
                                         load_width(codes, m / 2), out);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA takes at M sub-spaces: the wrapper checks
// it before launching, and select_kernel.smem_bytes mirrors it.
extern "C" long long repro_fastscan_select_grouped_smem(int m) {
  return static_cast<long long>(smem_bytes(m));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// tile_n (dividing n) is the reference's tile; the kernel's chunks do not
// depend on it.
extern "C" int repro_fastscan_select_grouped(const void* table,
                                             const void* codes, int g, int m,
                                             int n, int tile_n, void* out,
                                             void* stream) {
  (void)tile_n;
  if (smem_bytes(m) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (m / 2) {
    case 1: err = launch<1>(t, c, g, n, o, s); break;
    case 2: err = launch<2>(t, c, g, n, o, s); break;
    case 3: err = launch<3>(t, c, g, n, o, s); break;
    case 4: err = launch<4>(t, c, g, n, o, s); break;
    case 6: err = launch<6>(t, c, g, n, o, s); break;
    case 8: err = launch<8>(t, c, g, n, o, s); break;
    case 12: err = launch<12>(t, c, g, n, o, s); break;
    case 16: err = launch<16>(t, c, g, n, o, s); break;
    default: err = launch_smem(t, c, g, m, n, o, s); break;
  }
  return static_cast<int>(err);
}
