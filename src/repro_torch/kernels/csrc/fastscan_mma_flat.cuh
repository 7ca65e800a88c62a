// Device code of the flat one-hot tensor-core scan K7c (K7b uses only the
// MMA and the LUT row stride; its own core, with the operands' roles
// swapped, is in fastscan_onehot_mma_flat.cu): the ADC sums of 16 queries
// over a block of code rows as u8 x u8 -> s32 mma.sync.m16n8k32, with the
// one-hot codes built in registers.
//
// One k-step is one packed code byte j, i.e. two sub-spaces:
//   A (16 x 32 u8, row-major): A[i, k] = LUT[q0 + i, 2j + k / 16, k % 16],
//     the CTA's 16 LUT rows, read from shared memory;
//   B (32 x 8 u8, col-major): B[k, r] = 1 when code row r's nibble of
//     sub-space 2j + k / 16 equals k % 16, else 0, built in each lane's
//     registers from the code byte (no shared-memory one-hot tile);
//   C (16 x 8 s32) accumulates over the M/2 k-steps: C[i, r] is the sum of
//     query q0 + i over code row r.
// Exact: every product is u8 * {0, 1}, and a sum has at most M terms of at
// most 255. Fragment layouts are the PTX ISA's for m16n8k32 with 8-bit
// integer operands (lane = 4 * groupID + threadID_in_group).
#pragma once

#include "fastscan_common.cuh"

namespace repro_cuda {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaQueries = 16;      // queries of a CTA: the MMA's m16
constexpr int kMmaChunkRows = 1024;  // code rows staged at a time
constexpr int kMmaBlocks = 4;        // n8 blocks a warp computes per pass
constexpr int kMmaPassRows = 8 * kMmaBlocks;

// Bytes of one query's LUT row in shared memory: M*16 plus 16, so that
// the 8 rows a warp's lanes read at once fall in distinct banks.
__host__ __device__ inline int mma_lut_stride(int m) { return m * 16 + 16; }

// Shared memory of the CTA's LUT rows and one staged chunk of code rows.
__host__ __device__ inline size_t mma_flat_smem(int m) {
  return static_cast<size_t>(kMmaQueries) * mma_lut_stride(m) +
         static_cast<size_t>(kMmaChunkRows) * (m / 2);
}

// The CTA's 16 LUT rows (queries q0 .. q0 + 15; zeros past q) into shared
// memory; byte loads, so that any table offset is fine.
__device__ __forceinline__ void stage_mma_luts(uint8_t* luts,
                                               const uint8_t* table, int q0,
                                               int q, int m) {
  const int stride = mma_lut_stride(m);
  for (int i = threadIdx.x; i < kMmaQueries * stride; i += blockDim.x) {
    const int qi = i / stride, e = i - qi * stride;
    luts[i] = (q0 + qi < q && e < m * 16)
                  ? table[static_cast<size_t>(q0 + qi) * m * 16 + e]
                  : 0;
  }
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

// The four one-hot bytes of code c (0..15) at the k entries 4t .. 4t + 3
// that lane t of a group holds: byte c & 3 is 1 when c >> 2 == t.
__device__ __forceinline__ uint32_t onehot_word(uint32_t c, uint32_t t) {
  return (c >> 2) == t ? 1u << (8 * (c & 3u)) : 0u;
}

// Sums of the CTA's 16 queries over kMmaBlocks n8 blocks of staged code
// rows r0 .. r0 + kMmaPassRows - 1 (rows >= `rows` get an all-zero one-hot
// column). Called by all 32 lanes of a warp. On return, for lane
// (g = lane / 4, t = lane % 4): acc[b][0..1] are query g's sums of rows
// r0 + 8b + 2t and + 1, acc[b][2..3] query g + 8's.
__device__ __forceinline__ void mma_pass(int (&acc)[kMmaBlocks][4],
                                         const uint8_t* luts,
                                         const uint8_t* tile, int r0,
                                         int rows, int m) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const uint32_t t = lane & 3;
  const int mh = m / 2;
  const uint8_t* lut_g = luts + g * mma_lut_stride(m) + 4 * t;
  const uint8_t* lut_g8 = lut_g + 8 * mma_lut_stride(m);
#pragma unroll
  for (int b = 0; b < kMmaBlocks; ++b)
    acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0;
  for (int j = 0; j < mh; ++j) {
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(lut_g + 32 * j);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(lut_g8 + 32 * j);
    const uint32_t a2 =
        *reinterpret_cast<const uint32_t*>(lut_g + 32 * j + 16);
    const uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(lut_g8 + 32 * j + 16);
#pragma unroll
    for (int b = 0; b < kMmaBlocks; ++b) {
      const int r = r0 + 8 * b + g;
      uint32_t b0 = 0, b1 = 0;
      if (r < rows) {
        const uint32_t code = tile[static_cast<size_t>(r) * mh + j];
        b0 = onehot_word(code & 15u, t);
        b1 = onehot_word(code >> 4, t);
      }
      mma_u8_m16n8k32(acc[b], a0, a1, a2, a3, b0, b1);
    }
  }
}

}  // namespace repro_cuda
