// K7b: flat 4-bit ADC as a one-hot matrix product on the tensor cores, for
// sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_onehot_mxu (Pallas body _onehot_mxu_kernel: a (tile_q, M*16)
// LUT block contracted with one-hot code planes on the MXU). Computes the
// same function as K7a:
//   out[q, n] = sum_m LUT[q, m, nibble_m(codes[n])]   (int32)
// for (Q, M, 16) u8 tables and (N, M/2) u8 codes, any Q and N (rows and
// queries past the ends are masked; the reference pads both to its tiles).
//
// Formulation: u8 x u8 -> s32 mma.sync.m16n8k32, one k-step a packed code
// byte j (sub-spaces 2j and 2j+1):
//   A (16 x 32, row-major): A[i, k] = 1 when code row i's nibble of
//     sub-space 2j + k / 16 equals k % 16, else 0 -- the one-hot of 16
//     code rows, built in registers (lane (g, t) holds rows g and g + 8);
//   B (32 x 8, col-major): B[k, c] = LUT[q0 + c, 2j + k / 16, k % 16] --
//     8 queries' LUT bytes as they lie in memory (lane (g, t) reads words
//     2t and 2t + 1 of query g's 32 bytes of byte j; the fragments' order
//     of k is fastscan_mma_flat.cuh's);
//   C (16 x 8 s32): C[i, c] is code row i's sum for query q0 + c.
// Exact: every product is {0, 1} * u8, and a sum has at most M terms of at
// most 255. Fragment layouts are the PTX ISA's for m16n8k32 with 8-bit
// integer operands (lane = 4 * groupID + threadID_in_group).
//
// Bound on the H100: memory. The (Q, N) i32 output is ~98% of the bytes;
// the useful work is M look-ups and adds a (query, row), far below the
// tensor cores' rate even counted as the product's 16x larger work.
//
// Design:
//   - a CTA computes QT query tiles (8 QT queries) over chunks of 128 RB
//     code rows, each warp 16 RB rows; QT x RB <= 8 is a template pair,
//     the largest QT that Q fills (QT = 8 from Q = 33 on), then RB = 8 / QT,
//     so that a warp always runs up to 8 independent MMAs a k-step: one
//     query tile at Q <= 8 over 8 row blocks, 8 query tiles at Q = 128
//     over one;
//   - the one-hot A is built once per (16 rows, k-step) and feeds the MMAs
//     of all QT query tiles; a lane's two words of a row are one byte
//     permute and one 64-bit shift, after a funnel shift and a lop3 for
//     four code bytes;
//   - B comes from the CTA's query block of LUTs, staged once in shared
//     memory in their own order, so that b0 and b1 are one 8-byte load
//     (rows padded to 8 words mod 32: the 16 lanes of a phase hit distinct
//     bank pairs);
//   - that core (LUT staging, plan, k-loop) and the cp.async ring's copies
//     are shared with K7c, in fastscan_mma_flat.cuh;
//   - persistent CTAs (as many as fit on the card) walk the chunks, with a
//     ring of 4 cp.async stages (3 chunks in flight), one barrier a chunk;
//   - the epilogue goes through shared memory: the accumulators are staged
//     as (query, row) tiles (rows padded by 4 words: conflict-free) in a
//     double buffer, and the previous chunk's tile leaves as 16-byte
//     streaming stores (st.global.cs, 512 RB contiguous bytes a query)
//     while the current chunk computes.
// Where the LUTs and buffers of (QT, 8 / QT) do not fit in shared memory
// (a large M), a CTA takes one row block and QT halves until they do.
#include <algorithm>

#include "fastscan_mma_flat.cuh"

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // code chunks in the cp.async ring

// Byte offsets: the query block's LUT rows, two staged output tiles, the
// code chunk ring.
struct Layout {
  size_t out, codes, code_bytes, total;
};

__host__ __device__ inline Layout layout(int m, int qt, int rb) {
  Layout l;
  const size_t rows = 16 * kWarps * static_cast<size_t>(rb);
  l.out = align16(static_cast<size_t>(8 * qt) * lut_words(m) * 4);
  l.codes = l.out + 2 * static_cast<size_t>(8 * qt) * (rows + 4) * 4;
  l.code_bytes = align16(rows * (m / 2));
  l.total = l.codes + kStages * l.code_bytes;
  return l;
}

inline FlatPlan plan(int q, int m) {
  return flat_plan(q, [m](int qt, int rb) { return layout(m, qt, rb).total; });
}

template <int QT, int RB>
__global__ void __launch_bounds__(kThreads) onehot_mma_flat_kernel(
    const uint8_t* __restrict__ table,  // (Q, M, 16)
    const uint8_t* __restrict__ codes,  // (N, M/2)
    int q, int m, int n, int n_chunks, int ctas_per_block,
    int32_t* __restrict__ out) {        // (Q, N)
  constexpr int kRows = 16 * kWarps * RB;  // code rows of a chunk
  constexpr int kOutStride = kRows + 4;    // words of a staged query row
  constexpr int kQueries = 8 * QT;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(m, QT, RB);
  const int mh = m / 2;
  const int sw = lut_words(m);
  uint32_t* luts = reinterpret_cast<uint32_t*>(smem);
  int32_t* staged = reinterpret_cast<int32_t*>(smem + l.out);
  uint8_t* ring = smem + l.codes;

  const int qblk = blockIdx.x / ctas_per_block;
  const int first = blockIdx.x - qblk * ctas_per_block;
  const int q0 = qblk * kQueries;
  const int nq = min(kQueries, q - q0);
  const int nqt = (nq + 7) / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  stage_lut_words<kThreads>(luts, table + static_cast<size_t>(q0) * m * 16,
                            nq, nqt, m);
  // lane (g, t) reads query g's words t of sub-spaces 2j and 2j + 1
  const uint2* lut_g = reinterpret_cast<const uint2*>(luts + g * sw) + t;
  const bool vec_out = (n & 3) == 0;
  auto chunk_rows = [&](int c) {
    return static_cast<int>(min(static_cast<long long>(kRows),
                                n - static_cast<long long>(c) * kRows));
  };
  auto load = [&](int c, int s) {
    copy_async<kThreads>(ring + s * l.code_bytes,
                         codes + static_cast<size_t>(c) * kRows * mh,
                         static_cast<size_t>(chunk_rows(c)) * mh);
  };

  // the ring: chunk i of this CTA in stage i % kStages
  for (int s = 0; s < kStages - 1; ++s) {
    const int c = first + s * ctas_per_block;
    if (c < n_chunks) load(c, s);
    cp_async_commit();
  }
  // chunk c's staged tile (buffer buf) to the output
  auto epilogue = [&](int c, int buf) {
    const long long row0 = static_cast<long long>(c) * kRows;
    const int rows = chunk_rows(c);
    const int32_t* st = staged + buf * kQueries * kOutStride;
    for (int i = tid; i < nq * (kRows / 4); i += kThreads) {
      const int qi = i / (kRows / 4);
      const int r4 = 4 * (i - qi * (kRows / 4));
      if (r4 >= rows) continue;
      const int4 v = *reinterpret_cast<const int4*>(st + qi * kOutStride + r4);
      int32_t* dst = out + static_cast<size_t>(q0 + qi) * n + row0 + r4;
      if (vec_out && r4 + 4 <= rows) {
        __stcs(reinterpret_cast<int4*>(dst), v);
      } else {
        __stcs(dst, v.x);
        if (r4 + 1 < rows) __stcs(dst + 1, v.y);
        if (r4 + 2 < rows) __stcs(dst + 2, v.z);
        if (r4 + 3 < rows) __stcs(dst + 3, v.w);
      }
    }
  };

  int i = 0, prev = -1;
  for (int c = first; c < n_chunks; c += ctas_per_block, ++i) {
    cp_async_wait<kStages - 2>();
    // chunk c's codes are in, the stage of chunk i - 1 is free, and the
    // tile of chunk i - 1 is staged
    __syncthreads();
    const int nc = c + (kStages - 1) * ctas_per_block;
    if (nc < n_chunks) load(nc, (i + kStages - 1) % kStages);
    cp_async_commit();
    if (prev >= 0) epilogue(prev, (i - 1) & 1);

    int acc[QT][RB][4];
    mma_rows<QT, RB>(acc,
                     ring + (i % kStages) * l.code_bytes +
                         (16 * RB * warp + g) * mh,
                     lut_g, sw, mh, nqt, t);
    // C[r, c] -> staged[query c][row r]
    int32_t* tile = staged + (i & 1) * kQueries * kOutStride;
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      if (qt < nqt) {
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          int32_t* s = tile + (8 * qt + 2 * t) * kOutStride +
                       16 * (RB * warp + b) + g;
          s[0] = acc[qt][b][0];
          s[kOutStride] = acc[qt][b][1];
          s[8] = acc[qt][b][2];
          s[kOutStride + 8] = acc[qt][b][3];
        }
      }
    }
    prev = c;
  }
  if (prev >= 0) {
    __syncthreads();
    epilogue(prev, (i - 1) & 1);
  }
}

template <int QT, int RB>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int q, int m,
                   int n, size_t smem, int32_t* out, cudaStream_t stream) {
  const auto kernel = onehot_mma_flat_kernel<QT, RB>;
  long long resident = 0;
  const cudaError_t err = resident_ctas(kernel, kThreads, smem, resident);
  if (err != cudaSuccess) return err;
  // persistent CTAs: as many as are resident, spread over the query blocks
  const long long rows = 16LL * kWarps * RB;
  const long long n_chunks = (n + rows - 1) / rows;
  const long long q_blocks = (q + 8LL * QT - 1) / (8LL * QT);
  const long long per_block = std::max(
      1LL, std::min(n_chunks, (resident + q_blocks - 1) / q_blocks));
  if (q_blocks * per_block >= (1LL << 31))
    return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(q_blocks * per_block), kThreads, smem,
           stream>>>(table, codes, q, m, n, static_cast<int>(n_chunks),
                     static_cast<int>(per_block), out);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA needs at least at M sub-spaces (one query
// tile, one row block; a launch takes the largest pair that fits): the
// wrapper checks it against the card's limit before launching.
extern "C" long long repro_fastscan_onehot_mma_flat_smem(int m) {
  return static_cast<long long>(layout(m, 1, 1).total);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_onehot_mma_flat(const void* table,
                                              const void* codes, int q, int m,
                                              int n, void* out, void* stream) {
  const FlatPlan p = plan(q, m);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define K7B_CASE(QT, RB)                                 \
  if (p.qt == QT && p.rb == RB)                          \
    err = launch<QT, RB>(t, c, q, m, n, p.smem, o, s);
  K7B_CASE(8, 1)
  K7B_CASE(4, 2) K7B_CASE(4, 1)
  K7B_CASE(2, 4) K7B_CASE(2, 1)
  K7B_CASE(1, 8) K7B_CASE(1, 1)
#undef K7B_CASE
  return static_cast<int>(err);
}
