// Device code shared by the fast-scan kernels (K1, K3-K5, K7a-K7c): the
// shared-memory LUT row sum of one packed code row, the register LUT read
// by byte permutes (K5), the block-wide staging copy into shared memory
// (K7a-K7c), and the block-wide bitonic sort of K1's per-tile top-kc
// selection.
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

// One entry of a 16-entry u8 LUT held in registers as four 32-bit words:
// two byte permutes (prmt) pick byte c & 7 of {w1:w0} and of {w3:w2}, a
// select on bit 3 picks between them -- the Hopper analogue of the paper's
// two 128-bit vqtbl1q_u8 shuffles, and of the reference's select tree.
__device__ __forceinline__ uint32_t lookup(const uint32_t (&w)[4],
                                           uint32_t c) {
  const uint32_t lo = __byte_perm(w[0], w[1], c & 7u);
  const uint32_t hi = __byte_perm(w[2], w[3], c & 7u);
  return ((c & 8u) ? hi : lo) & 0xffu;
}

// ADC sum of one packed row of MH bytes against the register LUT `lut`
// (2*MH sub-spaces, four words each), loaded vec (8, 4 or 1) bytes at a
// time; MH is a template argument so that the LUT stays in registers.
template <int MH>
__device__ __forceinline__ int select_row(const uint8_t* row,
                                          const uint32_t (&lut)[2 * MH][4],
                                          int vec) {
  int acc = 0;
  if constexpr (MH % 8 == 0) {
    if (vec == 8) {
#pragma unroll
      for (int j = 0; j < MH; j += 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + j);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t b = ((i < 4 ? v.x : v.y) >> (8 * (i & 3))) & 0xffu;
          acc += lookup(lut[2 * (j + i)], b & 15u) +
                 lookup(lut[2 * (j + i) + 1], b >> 4);
        }
      }
      return acc;
    }
  }
  if constexpr (MH % 4 == 0) {
    if (vec >= 4) {
#pragma unroll
      for (int j = 0; j < MH; j += 4) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(row + j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b = (v >> (8 * i)) & 0xffu;
          acc += lookup(lut[2 * (j + i)], b & 15u) +
                 lookup(lut[2 * (j + i) + 1], b >> 4);
        }
      }
      return acc;
    }
  }
#pragma unroll
  for (int j = 0; j < MH; ++j) {
    const uint32_t b = row[j];
    acc += lookup(lut[2 * j], b & 15u) + lookup(lut[2 * j + 1], b >> 4);
  }
  return acc;
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

// Ascending bitonic sort of n (a power of two) keys in shared memory by the
// whole block; starts and ends with every thread past a barrier.
template <typename Key>
__device__ void bitonic_sort(Key* keys, int n) {
  __syncthreads();
  for (int k2 = 2; k2 <= n; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const Key a = keys[i], b = keys[ixj];
          const bool up = (i & k2) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
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

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace repro_cuda
