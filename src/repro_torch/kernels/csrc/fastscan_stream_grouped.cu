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
// Bound on the H100: memory, by the function's own work. Each probed list
// is read (M/2 bytes a row; groups that probe the same list read it again,
// from L2 when it is still there) and its (cap,) i32 row of sums is
// written once: the output is two thirds of the bytes at M = 16. The
// kernel is held back by the look-up instead, as K5 is: about 200
// integer-ALU instructions (permutes, logic, adds) a quad of rows at
// M = 16, on a pipe that takes two warp instructions a clock an SM.
//
// Design: K5's (fastscan_select_grouped.cu) with one indirection -- a
// unit's rows come from the probed list in place, codes + (probes[g] * cap
// + row0) * M/2, never from a gathered copy.
//   - Persistent CTAs (as many as are resident) walk (group, chunk of
//     4,096 rows) units, four quads of rows a thread on the shared
//     four-row look-up (selectors4 / sum_rows4, read from the stage); a
//     quad's four sums leave as one 16-byte streaming (evict-first) store,
//     so that the output does not push the store's lists out of L2.
//   - A ring of three cp.async stages holds each unit's LUT (copied once a
//     unit) beside its code chunk; one barrier a unit. A -1 probe's unit
//     issues no copy and writes zeros.
//   - Units halve (down to 128 rows, two quads a thread at 2,048 rows and
//     one below) while they would not give every SM two, so that a launch
//     over one query's probes (G = 32) still spreads. Unit indices are
//     64-bit: any (G, cap) the wrapper takes fits.
//   - Alignment: a list starts 16-byte aligned only where cap * M/2 % 16
//     == 0, so the chunk copy takes 16-, 8- or 4-byte cp.async, the widest
//     the source allows, and byte loads below that; the stage itself is
//     always 16-byte aligned. An output row is 16-byte aligned only where
//     cap % 4 == 0; a quad elsewhere leaves as four scalar stores.
//   - M/2 outside the four-row set {1, 2, 3, 4, 6, 8, 12, 16}: CTAs walk
//     (group, 1,024 rows) units, the LUT staged with 16-byte copies and
//     read by row_sum from shared memory, which computes the same sums.
// The chunks do not depend on tile_n: every row of a group uses one LUT,
// so any split of the rows gives the same sums.
#include <algorithm>
#include <climits>

#include "fastscan_mma_flat.cuh"  // cp.async staging, resident_ctas

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kMaxQuads = 4;  // quads of rows a thread in a full unit
constexpr int kUnitRows = 4 * kThreads * kMaxQuads;  // rows of a full unit
constexpr int kStages = 3;
constexpr int kSmemRows = 4 * kThreads;  // rows of a unit at any other M

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
// the four-row path, else the LUT (stream_grouped_kernel.smem_bytes
// mirrors it).
__host__ __device__ inline size_t smem_bytes(int m) {
  return four_row_path(m / 2) ? layout(m, kUnitRows).total
                              : 16 * static_cast<size_t>(m);
}

// cp.async of W = 4 or 8 bytes (through L1: the .cg form takes only 16).
template <int W>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(W)
               : "memory");
}

// Starts the copy of `bytes` bytes from a src that is 8- or 4-byte (W)
// aligned into the 16-byte aligned dst by the whole block: W-byte
// cp.async, then byte loads for the tail. The caller commits the group.
template <int W>
__device__ __forceinline__ void copy_narrow_async(uint8_t* dst,
                                                  const uint8_t* src,
                                                  size_t bytes) {
  const size_t head = bytes & ~static_cast<size_t>(W - 1);
  for (size_t i = W * static_cast<size_t>(threadIdx.x); i < head;
       i += W * kThreads)
    cp_async_ca<W>(dst + i, src + i);
  for (size_t i = head + threadIdx.x; i < bytes; i += kThreads)
    dst[i] = src[i];
}

// Starts the copy of a list chunk into the 16-byte aligned dst: cp.async
// of 16, 8 or 4 bytes, the widest src's alignment allows, and byte loads
// (copy_async's) at a src of odd or 2-byte alignment.
__device__ __forceinline__ void copy_chunk_async(uint8_t* dst,
                                                 const uint8_t* src,
                                                 size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if ((a & 15) == 0 || (a & 3) != 0)
    copy_async<kThreads>(dst, src, bytes);
  else if ((a & 7) == 0)
    copy_narrow_async<8>(dst, src, bytes);
  else
    copy_narrow_async<4>(dst, src, bytes);
}

// The sums of a quad's `left` (>= 1) first rows at out[o ..]: one 16-byte
// streaming store where out + o is 16-byte aligned and the quad is whole,
// else one streaming store a row.
__device__ __forceinline__ void store_quad(int32_t* out, size_t o, int left,
                                           int4 sums) {
  int32_t* dst = out + o;
  if ((o & 3) == 0 && left >= 4) {
    __stcs(reinterpret_cast<int4*>(dst), sums);
  } else {
    __stcs(dst, sums.x);
    if (left > 1) __stcs(dst + 1, sums.y);
    if (left > 2) __stcs(dst + 2, sums.z);
    if (left > 3) __stcs(dst + 3, sums.w);
  }
}

// QUADS quads of rows a thread: units of up to 4 * kThreads * QUADS rows.
template <int MH, int QUADS>
__global__ void __launch_bounds__(kThreads) stream_grouped_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    int cap, int unit_rows, int chunks, long long n_units,
    int32_t* __restrict__ out) {         // (G, cap)
  constexpr int M = 2 * MH;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(M, unit_rows);
  const long long step = gridDim.x;

  auto load = [&](long long u, int s) {
    const long long grp = u / chunks;
    const int lid = __ldg(probes + grp);
    if (lid < 0) return;  // no copy: the unit writes zeros
    const int row0 = static_cast<int>(u - grp * chunks) * unit_rows;
    uint8_t* dst = smem + s * l.stage;
    copy_async<kThreads>(dst, table + grp * M * 16, 16 * M);
    copy_chunk_async(dst + l.lut,
                     codes + (static_cast<size_t>(lid) * cap + row0) * MH,
                     static_cast<size_t>(min(unit_rows, cap - row0)) * MH);
  };

  // the ring: unit i of this CTA (blockIdx.x + i * step) in stage i % 3
  for (int s = 0; s < kStages - 1; ++s) {
    const long long u = blockIdx.x + s * step;
    if (u < n_units) load(u, s);
    cp_async_commit();
  }
  int i = 0;
  for (long long u = blockIdx.x; u < n_units; u += step, ++i) {
    cp_async_wait<kStages - 2>();
    // unit i's LUT and codes are in, and every thread is done with the
    // stage of unit i - 1
    __syncthreads();
    const long long nu = u + (kStages - 1) * step;
    if (nu < n_units) load(nu, (i + kStages - 1) % kStages);
    cp_async_commit();

    const long long grp = u / chunks;
    const int row0 = static_cast<int>(u - grp * chunks) * unit_rows;
    const int rows = min(unit_rows, cap - row0);
    const size_t base = static_cast<size_t>(grp) * cap + row0;
    if (__ldg(probes + grp) < 0) {
#pragma unroll
      for (int qd = 0; qd < QUADS; ++qd) {
        const int r = 4 * (threadIdx.x + qd * kThreads);
        if (r >= rows) break;
        store_quad(out, base + r, rows - r, make_int4(0, 0, 0, 0));
      }
      continue;
    }
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
      store_quad(out, base + r, rows - r, sum_rows4<M>(lut, sel, msk));
    }
  }
}

// Any M: CTAs walk (group, 1,024 rows) units, the LUT in shared memory.
__global__ void __launch_bounds__(kThreads) stream_grouped_smem_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    int m, int cap, int chunks, long long n_units, int vec,
    int32_t* __restrict__ out) {         // (G, cap)
  extern __shared__ __align__(16) uint8_t lut[];  // (M, 16)
  const int mh = m / 2;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const long long grp = u / chunks;
    const int row0 = static_cast<int>(u - grp * chunks) * kSmemRows;
    const int rows = min(kSmemRows, cap - row0);
    int32_t* dst = out + static_cast<size_t>(grp) * cap + row0;
    const int lid = __ldg(probes + grp);
    if (lid < 0) {  // the same for the whole block
      for (int r = threadIdx.x; r < rows; r += kThreads) __stcs(dst + r, 0);
      continue;
    }
    __syncthreads();  // every thread is done with the last unit's LUT
    stage_bytes(lut, table + static_cast<size_t>(grp) * m * 16,
                16 * static_cast<size_t>(m));
    __syncthreads();
    const uint8_t* src = codes + (static_cast<size_t>(lid) * cap + row0) * mh;
    for (int r = threadIdx.x; r < rows; r += kThreads)
      __stcs(dst + r, row_sum(src + static_cast<size_t>(r) * mh, lut, mh,
                              vec));
  }
}

template <int MH, int QUADS>
cudaError_t launch_walk(const uint8_t* table, const uint8_t* codes,
                        const int32_t* probes, int g, int cap, int rows,
                        int32_t* out, cudaStream_t stream) {
  const Layout l = layout(2 * MH, rows);
  const auto kernel = stream_grouped_kernel<MH, QUADS>;
  long long resident = 0;
  cudaError_t err = resident_ctas(kernel, kThreads, l.total, resident);
  if (err != cudaSuccess) return err;
  const int chunks = (cap + rows - 1) / rows;
  const long long n_units = static_cast<long long>(g) * chunks;
  const long long grid = std::min(n_units, resident);
  kernel<<<static_cast<unsigned>(grid), kThreads, l.total, stream>>>(
      table, codes, probes, cap, rows, chunks, n_units, out);
  return cudaGetLastError();
}

template <int MH>
cudaError_t launch(const uint8_t* table, const uint8_t* codes,
                   const int32_t* probes, int g, int cap, int32_t* out,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // fewer rows a unit where the units would not fill every SM twice, and
  // then fewer quads a thread
  int rows = kUnitRows;
  while (rows > 128 &&
         static_cast<long long>(g) * ((cap + rows - 1) / rows) < 2LL * sms)
    rows /= 2;
  if (rows == kUnitRows)
    return launch_walk<MH, kMaxQuads>(table, codes, probes, g, cap, rows, out,
                                      stream);
  if (rows == kUnitRows / 2)
    return launch_walk<MH, kMaxQuads / 2>(table, codes, probes, g, cap, rows,
                                          out, stream);
  return launch_walk<MH, 1>(table, codes, probes, g, cap, rows, out, stream);
}

cudaError_t launch_smem(const uint8_t* table, const uint8_t* codes,
                        const int32_t* probes, int g, int m, int cap,
                        int32_t* out, cudaStream_t stream) {
  const int chunks = (cap + kSmemRows - 1) / kSmemRows;
  const long long n_units = static_cast<long long>(g) * chunks;
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      stream_grouped_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid = std::min(n_units, static_cast<long long>(INT_MAX));
  stream_grouped_smem_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                               stream>>>(table, codes, probes, m, cap, chunks,
                                         n_units, load_width(codes, m / 2),
                                         out);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA takes at M sub-spaces: the wrapper checks
// it before launching, and stream_grouped_kernel.smem_bytes mirrors it.
extern "C" long long repro_fastscan_stream_grouped_smem(int m) {
  return static_cast<long long>(smem_bytes(m));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// tile_n (dividing cap) is the reference's tile; the kernel's chunks do not
// depend on it.
extern "C" int repro_fastscan_stream_grouped(
    const void* table, const void* codes, const void* probes, int g, int m,
    int cap, int tile_n, void* out, void* stream) {
  (void)tile_n;
  if (smem_bytes(m) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* p = static_cast<const int32_t*>(probes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (m / 2) {
    case 1: err = launch<1>(t, c, p, g, cap, o, s); break;
    case 2: err = launch<2>(t, c, p, g, cap, o, s); break;
    case 3: err = launch<3>(t, c, p, g, cap, o, s); break;
    case 4: err = launch<4>(t, c, p, g, cap, o, s); break;
    case 6: err = launch<6>(t, c, p, g, cap, o, s); break;
    case 8: err = launch<8>(t, c, p, g, cap, o, s); break;
    case 12: err = launch<12>(t, c, p, g, cap, o, s); break;
    case 16: err = launch<16>(t, c, p, g, cap, o, s); break;
    default: err = launch_smem(t, c, p, g, m, cap, o, s); break;
  }
  return static_cast<int>(err);
}
