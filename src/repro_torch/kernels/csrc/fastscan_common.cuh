// Device code shared by the fast-scan kernels: the shared-memory LUT row
// sum of one packed code row (K1, K3, K4, and K5's and K7a's any-M paths),
// the four-rows-per-permute look-up (K1 and K7a load the codes with
// load_rows4; K3 and K5 stage them and read them with stage_rows4; all
// build selectors4 / sum_rows4 the same way), the block-wide staging copy
// into shared memory (K1, K3, K5, K7a), and the 64-bit (value, slot)
// selection key (K4, K7c).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_cuda {

// Larger than any reachable ADC sum; marks padded, filtered-out and
// invalid-probe slots.
constexpr int32_t kAccSentinel = 0x7fffffff;

// LUT sum of the 8 nibble codes in one 32-bit word of a packed row whose
// first byte is byte0 of the row; lut is (M, 16) u8 in shared memory.
__device__ __forceinline__ int sum_word(uint32_t word, const uint8_t* lut,
                                        int byte0) {
  int acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = (word >> (8 * i)) & 0xffu;
    const int sub = 2 * (byte0 + i);
    acc += lut[sub * 16 + (b & 15u)] + lut[(sub + 1) * 16 + (b >> 4)];
  }
  return acc;
}

// ADC sum of one packed row of mh bytes, loaded vec (8, 4 or 1) bytes at a
// time; the caller picks vec from mh and the store's alignment.
__device__ __forceinline__ int row_sum(const uint8_t* row, const uint8_t* lut,
                                       int mh, int vec) {
  int acc = 0;
  if (vec == 8) {
    for (int j = 0; j < mh; j += 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + j);
      acc += sum_word(v.x, lut, j) + sum_word(v.y, lut, j + 4);
    }
  } else if (vec == 4) {
    for (int j = 0; j < mh; j += 4)
      acc += sum_word(*reinterpret_cast<const uint32_t*>(row + j), lut, j);
  } else {
    for (int j = 0; j < mh; ++j) {
      const uint32_t b = row[j];
      acc += lut[(2 * j) * 16 + (b & 15u)] + lut[(2 * j + 1) * 16 + (b >> 4)];
    }
  }
  return acc;
}

// ---- four rows per byte permute (K1, K3, K5, K7a) -----------------------
// A sub-space's 16 u8 entries are four words: entries 0-7 in {w1:w0}, 8-15
// in {w3:w2}. A 16-bit selector holds four rows' low 3 code bits, one
// nibble each (bit 3 of a selector nibble would replicate the sign in
// prmt's default mode, so it stays 0): prmt(w0, w1, sel) and prmt(w2, w3,
// sel) give four entries each, and a byte mask made of the four codes' bit
// 3 picks between them with one lop3. The four entries e (one byte a row)
// are summed twice: as one 32-bit word, and their odd rows (one prmt) in
// 16-bit lanes; the even rows are the first sum less the odd ones shifted
// up a byte. At M <= 32 a sum is at most 8,160, so no carry crosses lanes.

// prmt.b32 in its default mode (a selector nibble's bit 3 replicates the
// sign of the byte it picks).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// Byte b of four consecutive rows' codes (MH bytes each, row-major).
template <int MH>
__device__ __forceinline__ uint32_t code_byte(const uint32_t (&cw)[MH],
                                              int b) {
  return (cw[b >> 2] >> (8 * (b & 3))) & 0xffu;
}

// The codes of `rows` (1..4) consecutive rows from src, zero past them, as
// MH words; vec (16, 4 or 1) is the widest load src's alignment allows.
template <int MH>
__device__ __forceinline__ void load_rows4(const uint8_t* src, int rows,
                                           int vec, uint32_t (&cw)[MH]) {
  if (rows == 4 && MH % 4 == 0 && vec == 16) {
#pragma unroll
    for (int i = 0; i < MH / 4; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
      cw[4 * i] = v.x;
      cw[4 * i + 1] = v.y;
      cw[4 * i + 2] = v.z;
      cw[4 * i + 3] = v.w;
    }
  } else if (rows == 4 && vec >= 4) {  // 4*MH bytes from a 4-aligned row
#pragma unroll
    for (int i = 0; i < MH; ++i)
      cw[i] = __ldg(reinterpret_cast<const uint32_t*>(src) + i);
  } else {
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < rows * MH)
          word |= static_cast<uint32_t>(__ldg(src + 4 * i + b)) << (8 * b);
      cw[i] = word;
    }
  }
}

// The codes of four consecutive rows staged in shared memory (K3, K5), as
// MH words: 16-, 8- or 4-byte loads, the widest that 4 * MH bytes a quad
// keeps aligned.
template <int MH>
__device__ __forceinline__ void stage_rows4(const uint8_t* src,
                                            uint32_t (&cw)[MH]) {
  if constexpr (MH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MH / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i];
      cw[4 * i] = v.x;
      cw[4 * i + 1] = v.y;
      cw[4 * i + 2] = v.z;
      cw[4 * i + 3] = v.w;
    }
  } else if constexpr (MH % 2 == 0) {
#pragma unroll
    for (int i = 0; i < MH / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(src)[i];
      cw[2 * i] = v.x;
      cw[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MH; ++i)
      cw[i] = reinterpret_cast<const uint32_t*>(src)[i];
  }
}

// Per sub-space: the selector (low 3 bits of the four rows' codes, one
// nibble each) and the byte mask of their bit 3.
template <int MH>
__device__ __forceinline__ void selectors4(const uint32_t (&cw)[MH],
                                           uint32_t (&sel)[2 * MH],
                                           uint32_t (&msk)[2 * MH]) {
  uint32_t xs[MH];  // xs[j]: byte j of rows 0..3, one byte each
  if constexpr (MH % 4 == 0) {
    // a 4 x 4 byte transpose of each column of words: eight prmt for four
    // bytes of the four rows
#pragma unroll
    for (int w = 0; w < MH / 4; ++w) {
      const uint32_t a = cw[w], b = cw[MH / 4 + w];
      const uint32_t c = cw[MH / 2 + w], d = cw[3 * MH / 4 + w];
      const uint32_t t0 = prmt(a, b, 0x5140), t1 = prmt(a, b, 0x7362);
      const uint32_t t2 = prmt(c, d, 0x5140), t3 = prmt(c, d, 0x7362);
      xs[4 * w] = prmt(t0, t2, 0x5410);
      xs[4 * w + 1] = prmt(t0, t2, 0x7632);
      xs[4 * w + 2] = prmt(t1, t3, 0x5410);
      xs[4 * w + 3] = prmt(t1, t3, 0x7632);
    }
  } else {
#pragma unroll
    for (int j = 0; j < MH; ++j)
      xs[j] = code_byte<MH>(cw, j) | code_byte<MH>(cw, MH + j) << 8 |
              code_byte<MH>(cw, 2 * MH + j) << 16 |
              code_byte<MH>(cw, 3 * MH + j) << 24;
  }
#pragma unroll
  for (int j = 0; j < MH; ++j) {
    // sub-space 2j: low nibbles; 2j + 1: high. With bit 3 of every nibble
    // cleared, one select of x and x >> 4 (of x >> 4 and x >> 8) puts
    // rows 0, 1 in byte 0 and rows 2, 3 in byte 2, and one prmt packs them
    const uint32_t x = xs[j];
    const uint32_t x0 = x & 0x77777777u, x4 = x0 >> 4, x8 = x0 >> 8;
    constexpr uint32_t kLo = 0x0f0f0f0fu;
    sel[2 * j] = prmt((x0 & kLo) | (x4 & ~kLo), 0, 0x4420);
    sel[2 * j + 1] = prmt((x4 & kLo) | (x8 & ~kLo), 0, 0x4420);
    // bit 3 of each row's nibble moved to its byte's sign, replicated
    msk[2 * j] = prmt(x << 4, 0, 0xba98);
    msk[2 * j + 1] = prmt(x, 0, 0xba98);
  }
}

// The four rows' sums against one (M, 16) LUT read as M 16-byte words
// (a broadcast load when every lane reads the same LUT), as int4 of rows
// 0..3.
template <int M>
__device__ __forceinline__ int4 sum_rows4(const uint4* lut,
                                          const uint32_t (&sel)[M],
                                          const uint32_t (&msk)[M]) {
  uint32_t all = 0, odd = 0;  // the entries as words; rows 1, 3 in lanes
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const uint4 w = lut[s];
    const uint32_t lo = prmt(w.x, w.y, sel[s]);
    const uint32_t hi = prmt(w.z, w.w, sel[s]);
    const uint32_t e = (lo & ~msk[s]) | (hi & msk[s]);
    all += e;
    odd += prmt(e, 0, 0x4341);
  }
  const uint32_t even = all - (odd << 8);  // rows 0, 2 in 16-bit lanes
  return make_int4(static_cast<int>(even & 0xffffu),
                   static_cast<int>(odd & 0xffffu),
                   static_cast<int>(even >> 16), static_cast<int>(odd >> 16));
}

// True for the M/2 that the four-row look-up is instantiated for.
__host__ __device__ inline bool four_row_path(int mh) {
  switch (mh) {
    case 1: case 2: case 3: case 4: case 6: case 8: case 12: case 16:
      return true;
    default:
      return false;
  }
}

// Copy `bytes` bytes of device memory into shared memory with the whole
// block, 16 bytes a load when both ends are 16-byte aligned; the caller
// synchronizes before reading.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            size_t bytes) {
  size_t head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15u) == 0) {
    head = bytes & ~static_cast<size_t>(15);
    for (size_t i = 16 * static_cast<size_t>(threadIdx.x); i < head;
         i += 16 * static_cast<size_t>(blockDim.x))
      *reinterpret_cast<uint4*>(dst + i) =
          __ldg(reinterpret_cast<const uint4*>(src + i));
  }
  for (size_t i = head + threadIdx.x; i < bytes; i += blockDim.x)
    dst[i] = src[i];
}

// The 64-bit selection key of one row: ascending key order is ascending
// value with the lowest slot first among equal values.
__device__ __forceinline__ unsigned long long slot_key(int32_t val, int slot) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(val)) << 32) |
         static_cast<uint32_t>(slot);
}

// Load width for rows of mh bytes starting at addr: 8, 4 or 1 bytes.
inline int load_width(const void* addr, int mh) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(addr);
  return (mh % 8 == 0 && a % 8 == 0) ? 8 : (mh % 4 == 0 && a % 4 == 0) ? 4 : 1;
}

}  // namespace repro_cuda
