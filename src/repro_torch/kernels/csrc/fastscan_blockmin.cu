// K7c: flat 4-bit ADC fused with a per-block min and argmin, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_blockmin (Pallas body _blockmin_kernel: K7b's one-hot product,
// then per (query, N tile) jnp.min and the first-occurrence jnp.argmin as
// a global row id). Computes, for blocks of `block` rows (any block
// dividing N):
//   mins[q, b] = min over the rows n of block b of
//                sum_m LUT[q, m, nibble_m(codes[n])]
//   ids[q, b]  = the lowest such n reaching that min (a global row id)
//
// Formulation: K7b's sums on K7b's core (fastscan_mma_flat.cuh: A the
// one-hot of 16 code rows, built once a k-step and fed to up to 8 query
// tiles; B the query block's LUT words from shared memory), folded into
// the minimum where K7b stores them. Nothing of the (Q, N) sums leaves the
// chip.
//
// Bound on the H100: memory. It reads the codes once a query block and the
// LUTs, and writes two i32 per (query, block): ~9 MB at Q=128, N=1M, M=16.
// Its own work, M look-ups and adds a (query, row), is 4.1 G integer
// operations there, under the bytes' time even at the card's fastest
// integer rate. What limits this kernel is the product, at 16x the
// function's own work: its m16n8k32 MMAs (8 M a call at Q = 128, N = 1M,
// M = 16) with their one-hot build and fold.
//
// Design:
//   - (query tiles QT, row blocks RB) as K7b: a CTA takes 8 QT queries, each
//     warp 16 RB rows a pass; a chunk is one pass of 128 RB rows, or two
//     at RB = 1, so that a barrier and a chunk's bookkeeping cover at least
//     64 MMAs a warp;
//   - persistent CTAs, each owning a run of whole blocks of one query
//     block, so that no block is split between CTAs and every (query,
//     block) result is written once, by its owner, with no atomics; the
//     codes are read once a query block (twice at Q = 128); a CTA walks its
//     chunks with running counters (no division a chunk);
//   - a block of more than half a chunk is walked in chunks that end where
//     it ends; each lane keeps its best per query column over its rows: a
//     32-bit key sum << 16 | row in the block where both fit in 16 bits
//     (M * 255 < 65535, blocks up to 65,536 rows), whose unsigned min is
//     the lowest row among equal sums, else a (sum, row) pair updated on a
//     strict less-than in increasing row order; at the block's end the 8
//     lane groups are merged with shuffles and the warps through shared
//     memory on (sum << 32 | row) keys;
//   - smaller blocks come whole, several a chunk: the chunk's sums are
//     staged as (query, row) in shared memory, and one thread a (query,
//     block) takes the minimum in row order;
//   - a ring of 4 cp.async stages holds the chunks, one barrier a chunk.
// Where the LUTs and buffers of (QT, 8 / QT) do not fit in shared memory
// (a large M), a CTA takes one row block and QT halves until they do.
#include <algorithm>

#include "fastscan_mma_flat.cuh"

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // code chunks in the cp.async ring

// Byte offsets: the query block's LUT words, the warps' keys, the staged
// (query, row) sums (only for blocks of at most half a chunk), the ring.
struct Layout {
  size_t red, staged, codes, code_bytes, total;
};

// Rows of a chunk: passes of 128 RB rows (each warp 16 RB rows a pass), at
// least 256, so that a barrier and a chunk's bookkeeping cover at least 64
// MMAs a warp.
__host__ __device__ constexpr int passes(int rb) { return rb == 1 ? 2 : 1; }
__host__ __device__ constexpr int chunk_rows(int rb) {
  return 16 * kWarps * rb * passes(rb);
}

// Whole blocks a chunk holds when they are at most half a chunk, else 0.
__host__ __device__ inline int blocks_a_chunk(int rb, int block) {
  return chunk_rows(rb) / block >= 2 ? chunk_rows(rb) / block : 0;
}

__host__ __device__ inline Layout layout(int m, int qt, int rb,
                                         bool staged) {
  Layout l;
  const size_t rows = chunk_rows(rb);
  l.red = align16(static_cast<size_t>(8 * qt) * lut_words(m) * 4);
  l.staged = l.red + static_cast<size_t>(kWarps) * 8 * qt * 8;
  l.codes = l.staged + (staged ? static_cast<size_t>(8 * qt) * (rows + 4) * 4
                               : 0);
  l.code_bytes = align16(rows * (m / 2));
  l.total = l.codes + kStages * l.code_bytes;
  return l;
}

inline FlatPlan plan(int q, int m, int block) {
  return flat_plan(q, [m, block](int qt, int rb) {
    return layout(m, qt, rb, blocks_a_chunk(rb, block) > 0).total;
  });
}

template <int QT, int RB, bool kKey32>
__global__ void __launch_bounds__(kThreads, 2) blockmin_kernel(
    const uint8_t* __restrict__ table,  // (Q, M, 16)
    const uint8_t* __restrict__ codes,  // (N, M/2)
    int q, int m, int block, int n_blocks, int ctas_per_qblock,
    int32_t* __restrict__ mins,         // (Q, N / block)
    int32_t* __restrict__ ids) {        // (Q, N / block)
  constexpr int kPassRows = 16 * kWarps * RB;  // code rows of a pass
  constexpr int kRows = chunk_rows(RB);        // code rows of a chunk
  constexpr int kOutStride = kRows + 4;  // words of a staged query row
  constexpr int kQueries = 8 * QT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_chunk = blocks_a_chunk(RB, block);  // 0: long blocks
  const Layout l = layout(m, QT, RB, per_chunk > 0);
  const int mh = m / 2;
  const int sw = lut_words(m);
  uint32_t* luts = reinterpret_cast<uint32_t*>(smem);
  auto* red = reinterpret_cast<unsigned long long*>(smem + l.red);
  int32_t* staged = reinterpret_cast<int32_t*>(smem + l.staged);
  uint8_t* ring = smem + l.codes;

  const int qblk = blockIdx.x / ctas_per_qblock;
  const int part = blockIdx.x - qblk * ctas_per_qblock;
  const int q0 = qblk * kQueries;
  const int nq = min(kQueries, q - q0);
  const int nqt = (nq + 7) / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this CTA's blocks b0 .. b1 - 1
  const int b0 = static_cast<int>(static_cast<long long>(n_blocks) * part /
                                  ctas_per_qblock);
  const int b1 = static_cast<int>(static_cast<long long>(n_blocks) *
                                  (part + 1) / ctas_per_qblock);
  // chunks: per_chunk whole blocks each, or `parts` chunks a block
  const int parts = per_chunk ? 1 : (block + kRows - 1) / kRows;
  const int n_items = per_chunk ? (b1 - b0 + per_chunk - 1) / per_chunk
                                : (b1 - b0) * parts;
  // a chunk as (its first block, its part of that block): its first row
  // and rows, and the chunk after it
  auto span = [&](int blk, int p, long long& row0, int& rows) {
    row0 = static_cast<long long>(blk) * block +
           static_cast<long long>(p) * kRows;
    rows = per_chunk ? min(per_chunk, b1 - blk) * block
                     : min(kRows, block - p * kRows);
  };
  auto advance = [&](int& blk, int& p) {
    if (per_chunk) {
      blk += per_chunk;
    } else if (++p == parts) {
      p = 0;
      ++blk;
    }
  };
  int load_blk = b0, load_p = 0;  // the next chunk to load
  auto load = [&](int s) {
    long long row0;
    int rows;
    span(load_blk, load_p, row0, rows);
    copy_async<kThreads>(ring + s * l.code_bytes, codes + row0 * mh,
                         static_cast<size_t>(rows) * mh);
    advance(load_blk, load_p);
  };

  stage_lut_words<kThreads>(luts, table + static_cast<size_t>(q0) * m * 16,
                            nq, nqt, m);
  const uint2* lut_g = reinterpret_cast<const uint2*>(luts + g * sw) + t;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_items) load(s);
    cp_async_commit();
  }

  // long blocks: lane (g, t)'s best of query 8 qt + 2t + e so far in the
  // block. With kKey32 a key sum << 16 | row in the block (one shift-add
  // and one unsigned min a sum; none reaches the empty key ~0u); else the
  // pair (key = sum, at = global row), a strict less-than in row order.
  constexpr uint32_t kEmpty = kKey32 ? 0xffffffffu : 0x7fffffffu;
  uint32_t key[QT][2];
  int at[QT][2];
  auto reset = [&]() {
#pragma unroll
    for (int qt = 0; qt < QT; ++qt) {
      key[qt][0] = key[qt][1] = kEmpty;
      at[qt][0] = at[qt][1] = 0x7fffffff;
    }
  };
  reset();
  const int lane_row = 16 * RB * warp + g;  // its first row in a pass

  int blk = b0, p = 0;  // chunk i
  for (int i = 0; i < n_items; ++i, advance(blk, p)) {
    cp_async_wait<kStages - 2>();
    // chunk i's codes are in, and the stage of chunk i - 1 is free
    __syncthreads();
    if (i + kStages - 1 < n_items) load((i + kStages - 1) % kStages);
    cp_async_commit();
    long long row0;
    int rows;
    span(blk, p, row0, rows);

    for (int ps = 0; ps < passes(RB); ++ps) {
      const int pass_row = ps * kPassRows + lane_row;  // lane's first row
      int acc[QT][RB][4];
      mma_rows<QT, RB>(acc,
                       ring + (i % kStages) * l.code_bytes + pass_row * mh,
                       lut_g, sw, mh, nqt, t);
      if (!per_chunk) {
        // C[r, c]: rows pass_row + 16b + 8h, queries 8qt + 2t + e
        const int base = kKey32 ? p * kRows + pass_row
                                : static_cast<int>(row0) + pass_row;
#pragma unroll
        for (int b = 0; b < RB; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (pass_row + 16 * b + 8 * h < rows) {
              const int row = base + 16 * b + 8 * h;
#pragma unroll
              for (int qt = 0; qt < QT; ++qt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int s = acc[qt][b][2 * h + e];
                  if (kKey32) {
                    key[qt][e] = min(key[qt][e],
                                     (static_cast<uint32_t>(s) << 16) + row);
                  } else if (s < static_cast<int>(key[qt][e])) {
                    key[qt][e] = s;
                    at[qt][e] = row;
                  }
                }
            }
          }
      } else {
        // C[r, c] -> staged[query c][row r]
#pragma unroll
        for (int qt = 0; qt < QT; ++qt) {
          if (qt < nqt) {
#pragma unroll
            for (int b = 0; b < RB; ++b) {
              int32_t* st = staged + (8 * qt + 2 * t) * kOutStride +
                            pass_row + 16 * b;
              st[0] = acc[qt][b][0];
              st[kOutStride] = acc[qt][b][1];
              st[8] = acc[qt][b][2];
              st[kOutStride + 8] = acc[qt][b][3];
            }
          }
        }
      }
    }
    if (!per_chunk) {
      if (p == parts - 1) {  // the chunk ends block blk
        const int first = blk * block;
#pragma unroll
        for (int qt = 0; qt < QT; ++qt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // min over the 8 lane groups, then the (sum << 32 | global
            // row) key
            unsigned long long k;
            if (kKey32) {
              uint32_t k32 = key[qt][e];
#pragma unroll
              for (int x = 4; x < 32; x <<= 1)
                k32 = min(k32, __shfl_xor_sync(0xffffffffu, k32, x));
              k = k32 == kEmpty ? ~0ull
                                : slot_key(k32 >> 16, first + (k32 & 0xffffu));
            } else {
              k = slot_key(key[qt][e], at[qt][e]);
#pragma unroll
              for (int x = 4; x < 32; x <<= 1) {
                const unsigned long long o =
                    __shfl_xor_sync(0xffffffffu, k, x);
                k = o < k ? o : k;
              }
            }
            if (g == 0) red[warp * kQueries + 8 * qt + 2 * t + e] = k;
          }
        reset();
        __syncthreads();
        if (tid < nq) {
          unsigned long long k = red[tid];
          for (int w = 1; w < kWarps; ++w) {
            const unsigned long long o = red[w * kQueries + tid];
            k = o < k ? o : k;
          }
          const size_t o = static_cast<size_t>(q0 + tid) * n_blocks + blk;
          mins[o] = static_cast<int32_t>(k >> 32);
          ids[o] = static_cast<int32_t>(k & 0xffffffffu);
        }
      }
    } else {
      // one thread a (query, block) of the chunk's whole blocks
      __syncthreads();
      const int nblk = rows / block;
      for (int pair = tid; pair < nq * nblk; pair += kThreads) {
        const int qi = pair / nblk, bi = pair - qi * nblk;
        const int32_t* sr = staged + qi * kOutStride + bi * block;
        int v = sr[0], a = 0;
        for (int r = 1; r < block; ++r)
          if (sr[r] < v) {
            v = sr[r];
            a = r;
          }
        const size_t o = static_cast<size_t>(q0 + qi) * n_blocks + blk + bi;
        mins[o] = v;
        ids[o] = static_cast<int>(row0) + bi * block + a;
      }
    }
  }
}

template <int QT, int RB>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int q, int m,
                   int n, int block, size_t smem, int32_t* mins, int32_t* ids,
                   cudaStream_t stream) {
  // 32-bit keys hold a sum (< M * 255 + 1) and a row in the block in 16
  // bits each
  const auto kernel = (m * 255 < 0xffff && block <= 0x10000)
                          ? blockmin_kernel<QT, RB, true>
                          : blockmin_kernel<QT, RB, false>;
  long long resident = 0;
  const cudaError_t err = resident_ctas(kernel, kThreads, smem, resident);
  if (err != cudaSuccess) return err;
  // persistent CTAs: as many as are resident, spread over the query
  // blocks, each a run of whole blocks
  const long long n_blocks = n / block;
  const long long q_blocks = (q + 8LL * QT - 1) / (8LL * QT);
  const long long per_q = std::max(
      1LL, std::min(n_blocks, (resident + q_blocks - 1) / q_blocks));
  if (q_blocks * per_q >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(q_blocks * per_q), kThreads, smem,
           stream>>>(table, codes, q, m, block, static_cast<int>(n_blocks),
                     static_cast<int>(per_q), mins, ids);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA needs at least at M sub-spaces (one query
// tile, one row block, staged sums; a launch takes the largest pair that
// fits): the wrapper checks it against the card's limit before launching.
extern "C" long long repro_fastscan_blockmin_smem(int m) {
  return static_cast<long long>(layout(m, 1, 1, true).total);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_blockmin(const void* table, const void* codes,
                                       int q, int m, int n, int block,
                                       void* mins, void* ids, void* stream) {
  const FlatPlan p = plan(q, m, block);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* mn = static_cast<int32_t*>(mins);
  auto* id = static_cast<int32_t*>(ids);
  auto* s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define K7C_CASE(QT, RB)                                              \
  if (p.qt == QT && p.rb == RB)                                       \
    err = launch<QT, RB>(t, c, q, m, n, block, p.smem, mn, id, s);
  K7C_CASE(8, 1)
  K7C_CASE(4, 2) K7C_CASE(4, 1)
  K7C_CASE(2, 4) K7C_CASE(2, 1)
  K7C_CASE(1, 8) K7C_CASE(1, 1)
#undef K7C_CASE
  return static_cast<int>(err);
}
