// Device code shared by the one-hot tensor-core scans K6 (grouped), K7b
// (flat sums) and K7c (flat block min): 4-bit ADC sums as u8 x u8 -> s32
// mma.sync.m16n8k32, with the one-hot codes built in registers.
//
// One k-step is one packed code byte j, i.e. two sub-spaces, and k runs in
// the LUT's own byte order: k = 16h + v is code v of sub-space 2j + h.
// The fragments (lane = 4 * groupID g + threadID_in_group t) are laid over
// it so that each lane holds one nibble: lane t's k entries are those of
// sub-space 2j + (t >> 1), codes c0 .. c0 + 3 (its first A and B words)
// and c0 + 4 .. c0 + 7 (its second), c0 = 8 (t & 1). So
//   A (16 x 32, row-major): the one-hot of 16 code rows; lane (g, t)'s
//     words are those of rows g and g + 8, built in registers;
//   B (32 x 8, col-major): 8 LUT rows; lane (g, t)'s two words are words
//     2t and 2t + 1 of LUT row g's 32 bytes of byte j, one 8-byte load;
//   C (16 x 8 s32): C[i, c] is code row i's sum under LUT row c.
// (Any order of k gives the same sums, as long as A and B share it.)
// Exact: every product is {0, 1} * u8, and a sum has at most M terms of at
// most 255. Fragment layouts are the PTX ISA's for m16n8k32 with 8-bit
// integer operands.
//
// Here: the MMA, the one-hot words, the cp.async staging of code chunks
// and the persistent-grid size (every kernel walks row chunks with a ring
// of cp.async stages; K5, which has no MMA, takes these two too), and the
// flat kernels' core -- a query block's LUT staged as B words, the
// (query tiles, row blocks) plan, and the k-loop over a chunk of rows.
#pragma once

#include "fastscan_common.cuh"

namespace repro_cuda {

// Dynamic shared memory one block can get on Hopper.
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ void mma_u8_m16n8k32(int (&c)[4], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The one-hot shifts of lane t's nibble of the four code bytes of w: byte
// k is 8 * (c ^ c0) for that nibble c, in [0, 56] exactly when c >> 3 ==
// t & 1 (c0 = 8 (t & 1); rot = 29 for the low nibble, t < 2, else 1; c0x
// = 64 (t & 1) * 0x01010101). The xor needs no borrow, so the four bytes
// stay apart: a funnel shift and a lop3 for four code bytes.
__device__ __forceinline__ uint32_t nibble_shifts(uint32_t w, uint32_t rot,
                                                  uint32_t c0x) {
  return (__funnelshift_r(w, w, rot) & 0x78787878u) ^ c0x;
}

// Lane t's two one-hot words of code byte k, from nibble_shifts' output:
// 1 << shift as 64 bits, i.e. byte c - c0 of the pair (lo: codes c0 ..
// c0 + 3, hi: c0 + 4 .. c0 + 7), and zero for a shift >= 64 (shl clamps).
// One byte permute and one 64-bit shift.
__device__ __forceinline__ void onehot_pair(uint32_t shifts, int k,
                                            uint32_t& lo, uint32_t& hi) {
  asm("{\n\t.reg .b64 v;\n\t"
      "shl.b64 v, %2, %3;\n\t"
      "mov.b64 {%0, %1}, v;\n\t}"
      : "=r"(lo), "=r"(hi)
      : "l"(1ull), "r"(__byte_perm(shifts, 0u, 0x4440u + k)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of `bytes` bytes from src into the 16-byte aligned dst,
// by all kThreads threads of the block: 16-byte cp.async where src is
// 16-byte aligned, plain loads for the tail and for any other src. The
// caller commits the group.
template <int kThreads>
__device__ __forceinline__ void copy_async(uint8_t* dst, const uint8_t* src,
                                           size_t bytes) {
  const size_t head = (reinterpret_cast<uintptr_t>(src) & 15) == 0
                          ? bytes & ~static_cast<size_t>(15)
                          : 0;
  for (size_t i = 16 * static_cast<size_t>(threadIdx.x); i < head;
       i += 16 * kThreads)
    cp_async16(dst + i, src + i);
  for (size_t i = head + threadIdx.x; i < bytes; i += kThreads)
    dst[i] = src[i];
}

// The CTAs of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that are resident on the card at once, after raising the
// kernel's shared-memory limit to smem: the grid of a persistent launch.
template <class Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads, size_t smem,
                                 long long& resident) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  resident = static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  return cudaSuccess;
}

// ---- the flat scans (K7b, K7c): Q queries' LUTs against N code rows ----

// Words of one query's staged LUT row: 4M, padded to 8 mod 32, so that
// the 16 lanes of a phase reading 8-byte pairs hit distinct bank pairs.
__host__ __device__ inline int lut_words(int m) {
  return 4 * m + ((8 - 4 * m) % 32 + 32) % 32;
}

// The LUT rows of queries 0 .. nq - 1 of `tab` (the query block's first
// row) as B words, lut_words(m) words a query, in the LUT's own order;
// zeros from query nq to the end of its query tile. Byte loads, so that
// any table offset is fine.
template <int kThreads>
__device__ __forceinline__ void stage_lut_words(uint32_t* luts,
                                                const uint8_t* tab, int nq,
                                                int nqt, int m) {
  const int sw = lut_words(m);
  for (int i = threadIdx.x; i < 8 * nqt * 4 * m; i += kThreads) {
    const int qi = i / (4 * m), w = i - qi * 4 * m;
    uint32_t v = 0;
    if (qi < nq) {
      const uint8_t* p = tab + static_cast<size_t>(qi) * m * 16 + 4 * w;
      v = p[0] | p[1] << 8 | p[2] << 16 | static_cast<uint32_t>(p[3]) << 24;
    }
    luts[qi * sw + w] = v;
  }
}

// The sums of QT query tiles (the first nqt real) over RB blocks of 16
// staged code rows: acc[qt][b] is C of query tile qt and row block b. For
// lane (g, t): rows_g is its row g of row block 0 (row blocks 16 rows, rows
// mh bytes apart), lut_g its pair t of query g's staged words (query tiles
// 8 * sw words apart). The one-hot A of a (row block, k-step) is built once
// and feeds the MMAs of all query tiles.
template <int QT, int RB>
__device__ __forceinline__ void mma_rows(int (&acc)[QT][RB][4],
                                         const uint8_t* rows_g,
                                         const uint2* lut_g, int sw, int mh,
                                         int nqt, uint32_t t) {
#pragma unroll
  for (int a = 0; a < QT; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0;
  const uint32_t rot = t < 2 ? 29u : 1u, c0x = (t & 1) ? 0x40404040u : 0u;
  uint32_t x[RB], x8[RB];  // nibble shifts of rows g and g + 8
  // k-step j from byte k of each row block's shifts
  auto kstep = [&](int j, int k) {
    uint2 bv[QT];
#pragma unroll
    for (int qt = 0; qt < QT; ++qt)
      if (qt < nqt) bv[qt] = lut_g[qt * 4 * sw + 4 * j];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      uint32_t a0, a1, a2, a3;
      onehot_pair(x[b], k, a0, a2);
      onehot_pair(x8[b], k, a1, a3);
#pragma unroll
      for (int qt = 0; qt < QT; ++qt)
        if (qt < nqt)
          mma_u8_m16n8k32(acc[qt][b], a0, a1, a2, a3, bv[qt].x, bv[qt].y);
    }
  };
  if (mh % 4 == 0) {  // rows start at multiples of 4 bytes
    for (int j = 0; j < mh; j += 4) {
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        x[b] = nibble_shifts(
            *reinterpret_cast<const uint32_t*>(rows_g + 16 * b * mh + j), rot,
            c0x);
        x8[b] = nibble_shifts(*reinterpret_cast<const uint32_t*>(
                                  rows_g + (16 * b + 8) * mh + j),
                              rot, c0x);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) kstep(j + k, k);
    }
  } else {
    for (int j = 0; j < mh; ++j) {
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        x[b] = nibble_shifts(rows_g[16 * b * mh + j], rot, c0x);
        x8[b] = nibble_shifts(rows_g[(16 * b + 8) * mh + j], rot, c0x);
      }
      kstep(j, 0);
    }
  }
}

struct FlatPlan {
  int qt, rb;  // query tiles (8 queries each) and 16-row blocks of a warp
  size_t smem;
};

// The largest query tile count that Q fills (up to 8), with 8 / QT row
// blocks, so that a warp always runs up to 8 independent MMAs a k-step;
// where total(QT, RB), the shared memory of that pair, does not fit, one
// row block and QT halving. smem > kSmemLimit: refused (QT = RB = 1 does
// not fit).
template <class Total>
inline FlatPlan flat_plan(int q, Total total) {
  int qt = 1;
  while (qt < 8 && 8 * qt < q) qt *= 2;
  if (total(qt, 8 / qt) <= kSmemLimit)
    return FlatPlan{qt, 8 / qt, total(qt, 8 / qt)};
  while (qt > 1 && total(qt, 1) > kSmemLimit) qt /= 2;
  return FlatPlan{qt, 1, total(qt, 1)};
}

}  // namespace repro_cuda
