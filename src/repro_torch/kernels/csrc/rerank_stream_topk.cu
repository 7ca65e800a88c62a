// K2: gather-free exact re-rank with a running top-k, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/rerank_kernel.py::rerank_stream_topk
// (Pallas body _rerank_kernel, merge _merge_topk, distance
// norms_gemm_dists). Computes what that kernel computes:
//   for each query q and each candidate position p (in chunks of tile_r):
//     d[p] = max((||q||^2 - 2 q.x) + xn[p], 0)  with x = base[cand[p]]
//     d[p] = +inf where cand[p] < 0
//   fold each chunk into a running top-k: running entries come before the
//   chunk's, earlier positions win ties, a non-finite value gets
//   position -1.
//
// Bound on the H100: memory in principle -- each candidate row is D*4
// bytes, gathered by id from the in-place base and read once for 2*D
// flops (2.76 MB at Q = 128, R = 40, D = 128). At the serving shapes a
// query is a few dozen rows, so its time is a chain of latencies: the
// candidate ids, the rows they name, the merge.
//
// Design: one CTA of 8 warps per query, each link of the chain paid once:
//   - warp w owns positions w, w + 8, ... of a chunk, in batches of 8;
//     lane b holds the id and ||x||^2 of a batch's b-th position, fetched
//     two batches ahead. The warp issues the 16-byte loads of all its
//     batch's rows (a float4 a lane of their first 128 columns) one batch
//     ahead, into one of two register buffers, before it reduces the
//     batch before: a batch is usually a whole chunk, so chunk c + 1's
//     rows are in flight while chunk c reduces, waits at its barrier and
//     merges. The eight rows' dots are reduced together (sums8: ten
//     shuffles, no branch). A pad or out-of-range id issues no load (its
//     dot is 0 and its distance +inf). q is read through
//     the read-only cache by every warp, which all reduce ||q||^2 in one
//     order.
//   - the merge is by rank. Distances are >= 0 or +inf, so their f32 bits
//     order as u32, and the 64-bit key (bits << 32) | position orders
//     exactly as _merge_topk (running entries, of earlier positions, come
//     first among equal values); positions differ, so keys do. Eight lanes
//     count the keys below each key: a running key i has rank i + the
//     chunk keys below it; a chunk key, the running keys below it (a
//     binary search, the running top-k being sorted) + the chunk keys
//     below it, and none above the running k-th key can enter. A key of
//     rank < k is written at its rank: no sort, no barrier inside.
//   - chunk c - 1 merges while chunk c + 1's rows are in flight, before
//     chunk c's are reduced: one barrier a chunk.
// A query stays on one CTA: at Q = 1 its 8 warps already have every row
// of a 64-position chunk in flight at once, and splitting the rows over
// CTAs would add a cross-CTA merge to the same chain of latencies.
// The dot and ||q||^2 are summed in another order than torch's reduction,
// so results agree with the plain version within an f32 tolerance, not
// bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // rows a warp loads before it reduces any
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// Shared memory of one CTA: the running top-k's keys, double-buffered,
// then a chunk's distances, double-buffered (rerank_kernel.smem_bytes
// mirrors it; D does not enter: q is not staged).
size_t smem_bytes(int d, int tile_r, int k) {
  (void)d;
  return 2 * static_cast<size_t>(k) * 8 + 2 * static_cast<size_t>(tile_r) * 4;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The warp-wide sums of a[0..7]; lane b < 8 returns a[b]'s. Each round
// halves the values a lane holds and sends the other half to its partner
// (4, 2, 1 shuffles), so lanes 4v .. 4v + 3 end with value v: 9 shuffles
// and one to fetch, not eight reductions of five.
__device__ __forceinline__ float sums8(const float (&a)[8], int lane) {
  float h[4], g[2];
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    h[v] = (b16 ? a[v + 4] : a[v]) +
           __shfl_xor_sync(kFull, b16 ? a[v] : a[v + 4], 16);
#pragma unroll
  for (int v = 0; v < 2; ++v)
    g[v] = (b8 ? h[v + 2] : h[v]) +
           __shfl_xor_sync(kFull, b8 ? h[v] : h[v + 2], 8);
  float s = (b4 ? g[1] : g[0]) + __shfl_xor_sync(kFull, b4 ? g[0] : g[1], 4);
  s += __shfl_xor_sync(kFull, s, 2);
  s += __shfl_xor_sync(kFull, s, 1);
  return __shfl_sync(kFull, s, 4 * (lane & 7));
}

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot(float a, float b) { return a * b; }

__device__ __forceinline__ unsigned long long dist_key(float v, unsigned p) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) | p;
}

// The running keys (k, ascending) below key.
__device__ __forceinline__ int count_below(const unsigned long long* run,
                                           int k, unsigned long long key) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// V: float4 (D % 4 == 0, base and q 16-byte aligned) or float columns.
template <class V>
__global__ void __launch_bounds__(kThreads) rerank_kernel(
    const float* __restrict__ base,      // (N, D), in place
    const float* __restrict__ q,         // (Q, D)
    const int32_t* __restrict__ cand,    // (Q, Rp), -1 = pad
    const float* __restrict__ xn,        // (Q, Rp) precomputed ||x||^2
    int n, int d, int rp, int tile_r, int k,
    float* __restrict__ out_vals, int32_t* __restrict__ out_pos) {
  extern __shared__ __align__(16) unsigned long long runs[];  // (2, k)
  float* cdist = reinterpret_cast<float*>(runs + 2 * k);      // (2, tile_r)
  constexpr int kVec = sizeof(V) / sizeof(float);
  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cols = d / kVec;              // a row as V
  const int slices = (cols + 31) / 32;    // a lane's V of a row
  const V* qrow = reinterpret_cast<const V*>(q + static_cast<size_t>(qi) * d);
  const int32_t* qcand = cand + static_cast<size_t>(qi) * rp;
  const float* qxn = xn + static_cast<size_t>(qi) * rp;
  const int n_chunks = rp / tile_r;
  // the warp's positions in a chunk; every warp walks warp 0's count of
  // batches a chunk (the most), so all reach each barrier together
  const int npos = warp < tile_r ? (tile_r - warp + kWarps - 1) / kWarps : 0;
  const int per_chunk = ((tile_r + kWarps - 1) / kWarps + kBatch - 1) / kBatch;
  const int total = n_chunks * per_chunk;

  // lane b's id and ||x||^2 in batch i of the walk (-1: none)
  auto fetch = [&](int i, int& cid, float& x) {
    cid = -1;
    x = 0.f;
    if (i >= total) return;
    const int c = i / per_chunk;
    const int b = (i - c * per_chunk) * kBatch + lane;
    if (lane < kBatch && b < npos) {
      const int p = c * tile_r + warp + kWarps * b;
      cid = __ldg(qcand + p);
      x = __ldg(qxn + p);
    }
  };
  // row b's id (lane b's) and whether it names a row (the same in every
  // lane)
  auto row_of = [&](int cid, int b, bool& ok) {
    const int id = __shfl_sync(kFull, cid, b);
    ok = id >= 0 && id < n;
    return reinterpret_cast<const V*>(base +
                                      static_cast<size_t>(ok ? id : 0) * d);
  };
  // the loads of the first 32 V columns of a batch's rows
  auto issue = [&](int cid, V (&x)[kBatch]) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      bool ok;
      const V* row = row_of(cid, b, ok);
      x[b] = ok && lane < cols ? __ldg(row + lane) : V{};
    }
  };

  // fold chunk m (distances in cdist[m & 1]) into runs[m & 1] -> runs[(m +
  // 1) & 1], by rank, eight lanes a key
  auto merge = [&](int m) {
    const unsigned long long* run = runs + (m & 1) * k;
    unsigned long long* nxt = runs + ((m + 1) & 1) * k;
    const float* cd = cdist + (m & 1) * tile_r;
    const unsigned p0 = static_cast<unsigned>(m) * tile_r;
    const unsigned long long thr = run[k - 1];
    const int part = tid & 7;
    for (int e0 = 0; e0 < k + tile_r; e0 += kThreads / 8) {
      const int e = e0 + (tid >> 3);
      unsigned long long key = 0;
      bool live = false;
      int below = 0;
      if (e < k) {
        key = run[e];
        live = true;
      } else if (e < k + tile_r) {
        key = dist_key(cd[e - k], p0 + (e - k));
        live = key < thr;  // else the k running keys are all below it
      }
      if (live)
        for (int j = part; j < tile_r; j += 8)
          below += dist_key(cd[j], p0 + j) < key;
      below += __shfl_xor_sync(kFull, below, 1);
      below += __shfl_xor_sync(kFull, below, 2);
      below += __shfl_xor_sync(kFull, below, 4);
      if (part == 0 && live) {
        below += e < k ? e : count_below(run, k, key);
        if (below < k) nxt[below] = key;
      }
    }
  };

  int cid0, cid1;  // the lane's ids in the current and the next batch
  float xn0, xn1;
  fetch(0, cid0, xn0);
  fetch(1, cid1, xn1);
  // every warp reduces ||q||^2 in the same order, so all hold one value
  const V q0 = lane < cols ? __ldg(qrow + lane) : V{};
  float qn = dot(q0, q0);
  for (int s = lane + 32; s < cols; s += 32) {
    const V v = __ldg(qrow + s);
    qn += dot(v, v);
  }
  qn = warp_sum(qn);
  // the empty running top-k: +inf keys past every position, distinct
  for (int i = tid; i < k; i += kThreads)
    runs[i] = dist_key(INFINITY, 0x80000000u | static_cast<unsigned>(i));

  // batch i: its rows' first loads are in xc; the next batch's go out into
  // xnext before anything waits, and chunk c - 1 merges while they fly
  auto step = [&](int i, V (&xc)[kBatch], V (&xnext)[kBatch]) {
    const int c = i / per_chunk, t = i - c * per_chunk;
    if (i + 1 < total) issue(cid1, xnext);
    int cid2;
    float xn2;
    fetch(i + 2, cid2, xn2);
    if (t == 0 && c > 0) merge(c - 1);
    float acc[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) acc[b] = dot(xc[b], q0);
    for (int s = 1; s < slices; ++s) {
      const int col = lane + 32 * s;
      const V qv = col < cols ? __ldg(qrow + col) : V{};
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        bool ok;
        const V* row = row_of(cid0, b, ok);
        if (ok && col < cols) acc[b] += dot(__ldg(row + col), qv);
      }
    }
    const float mine = sums8(acc, lane);
    const int j = t * kBatch + lane;  // the lane's position index
    if (lane < kBatch && j < npos) {
      float dist = INFINITY;
      if (cid0 >= 0 && cid0 < n) {
        const float v = (qn - 2.0f * mine) + xn0;
        dist = v > 0.f ? v : 0.f;  // clamp; also maps -0.0 to +0.0
      }
      cdist[(c & 1) * tile_r + warp + kWarps * j] = dist;
    }
    // chunk c's distances and the merge of chunk c - 1 are published
    if (t == per_chunk - 1) __syncthreads();
    cid0 = cid1;
    xn0 = xn1;
    cid1 = cid2;
    xn1 = xn2;
  };

  V buf0[kBatch], buf1[kBatch];
  issue(cid0, buf0);
  for (int i = 0; i < total; i += 2) {
    step(i, buf0, buf1);
    if (i + 1 < total) step(i + 1, buf1, buf0);
  }
  if (n_chunks > 0) merge(n_chunks - 1);
  __syncthreads();

  const unsigned long long* fin = runs + (n_chunks & 1) * k;
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long key = fin[i];
    const float v = __uint_as_float(static_cast<uint32_t>(key >> 32));
    out_vals[static_cast<size_t>(qi) * k + i] = v;
    out_pos[static_cast<size_t>(qi) * k + i] =
        isfinite(v) ? static_cast<int32_t>(key & 0xffffffffu) : -1;
  }
}

template <class V>
cudaError_t launch(const void* base, const void* q, const void* cand,
                   const void* xn, int nq, int n, int d, int rp, int tile_r,
                   int k, void* out_vals, void* out_pos,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d, tile_r, k);
  cudaError_t err = cudaFuncSetAttribute(
      rerank_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rerank_kernel<V><<<nq, kThreads, smem, stream>>>(
      static_cast<const float*>(base), static_cast<const float*>(q),
      static_cast<const int32_t*>(cand), static_cast<const float*>(xn), n, d,
      rp, tile_r, k, static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_pos));
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA takes at (D, tile_r, k): the wrapper
// checks it before launching, and rerank_kernel.smem_bytes mirrors it.
extern "C" long long repro_rerank_stream_topk_smem(int d, int tile_r, int k) {
  return static_cast<long long>(smem_bytes(d, tile_r, k));
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_rerank_stream_topk(
    const void* base, const void* q, const void* cand, const void* xn, int nq,
    int n, int d, int rp, int tile_r, int k, void* out_vals, void* out_pos,
    void* stream) {
  if (smem_bytes(d, tile_r, k) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = d % 4 == 0 &&
                    ((reinterpret_cast<uintptr_t>(base) |
                      reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  auto* s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec4 ? launch<float4>(base, q, cand, xn, nq, n, d, rp, tile_r, k,
                            out_vals, out_pos, s)
           : launch<float>(base, q, cand, xn, nq, n, d, rp, tile_r, k,
                           out_vals, out_pos, s);
  return static_cast<int>(err);
}
