// K4: K1 with anytime early exit (tile pruning), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_stream_topk_grouped with early_exit=True (Pallas body
// _stream_topk_prune_kernel, merge _merge_smallest). Computes exactly what
// that kernel computes. For each query q (groups q*gpq .. q*gpq+gpq-1,
// query-major) its gpq*n_tiles (group, tile) steps run in flat order with a
// running top-kc of dequantized distances, run (all +inf at the start):
//   thr = run[kc-1];
//   a step is scanned iff probes[g] >= 0 and bounds[g] < thr; then
//     it emits K1's tile top-kc (vals, slots) and skipped = 0, and
//     d[i] = scale[g] * float(val[i]) + bias[g]   (+inf where slot < 0)
//     run = smallest kc of (run ++ d);
//   otherwise it reads nothing, emits ACC_SENTINEL / -1 and
//     skipped = (probes[g] >= 0).
//
// Why one CTA per query: the threshold tightens step by step, so which
// tiles are skipped depends on the flat step order. A CUDA grid has no
// order, so each query's steps run in order inside one CTA, with the
// block's 1024 threads parallel inside a tile. Q=1 is one CTA.
//
// Rounding: the dequantization is __fmul_rn then __fadd_rn, never an FMA,
// so the threshold rounds exactly as the host's two-op dequantization in
// core/ivf.py::scan_probes_stream and the skip decisions match the
// reference's.
//
// Bound on the H100: memory for the tiles it scans (M/2 bytes a row), as
// K1. What it pays instead is latency: a query's steps are serial, so a
// scanned step costs its chain of dependent loads, its block barriers and
// its selection. The design keeps each short:
//   - the step's group data (probe, list size, bound, scale, bias) come
//     from a window of 32 groups that every warp holds in registers, one
//     group a lane; a ballot finds the next step that passes the decision,
//     so deciding and looking ahead read no memory;
//   - the tile's top-kc without sorting the tile: a live sum is an integer
//     in [0, M*255], so a shared-memory histogram of the sums (a radix
//     select over digits of at most 13 bits; one pass up to M = 32) finds
//     the kc-th smallest value v*; the rows under v*, then the lowest-slot
//     rows equal to v*, are compacted in slot order with warp ballots;
//   - the kc survivors are sorted, and merged into the running top-kc, by
//     rank: one thread an element counts the elements that go before it,
//     so sort and merge take one phase, with no barrier between them;
//   - the next step's operands (its LUT, its live code rows, its filter
//     bytes) are copied by one thread with TMA 1-D bulk copies
//     (cp.async.bulk, completing on an mbarrier) into a second
//     shared-memory stage while the current step computes. The copy goes to the next step that
//     passes the current threshold; the threshold only tightens, so a
//     prefetch can be wasted but a skip is never wrong, and the decision at
//     compute time stays fresh (as the reference's
//     double_buffered_dma_gated). Where two stages do not fit (very large
//     tiles or M), or the rows are not 16-byte aligned, the LUT is copied
//     per step and the codes are read in place, or both are read in place.
// A scanned step needs six block barriers at M <= 32.
#include <math_constants.h>

#include "fastscan_common.cuh"

namespace {

using repro_cuda::kAccSentinel;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDigitBits = 13;  // histogram bins a pass: at most 8192
constexpr int kMaxPer = (1 << kMaxDigitBits) / kThreads;  // bins a thread
// the radix select's result, warp 0's prefetches, the stages' mbarriers
constexpr size_t kScratch = 48;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the shared-memory regions of one CTA (the select's warp
// totals share space with the compaction's per-warp counts).
//   stages = 2: two stages of (LUT, code rows, filter bytes), prefetched;
//   stages = 1: one LUT stage, copied per step, codes read in place;
//   stages = 0: LUT and codes read in place (an M too large for a stage).
// (The launcher runs a 2-stage layout with 1 stage where the rows or the
// filter bytes are not 16-byte aligned for the bulk copies.)
struct Layout {
  size_t counts, vals, bins, cand, dist, run, stage, stage_bytes, lut_bytes,
      code_bytes, total;
};

__host__ __device__ inline Layout layout(int tile_n, int kc, int m,
                                         int stages, int digit_bits) {
  Layout l;
  const size_t nchunk = (tile_n + kThreads - 1) / kThreads;
  l.counts = kScratch;
  l.vals = l.counts + nchunk * kWarps * 4;
  l.bins = l.vals + align16(static_cast<size_t>(tile_n) * 4);
  l.cand = l.bins + align16((static_cast<size_t>(1) << digit_bits) * 4);
  l.dist = l.cand + align16(static_cast<size_t>(kc) * 8);
  l.run = l.dist + align16(static_cast<size_t>(kc) * 4);
  l.stage = l.run + align16(static_cast<size_t>(kc) * 8);
  l.lut_bytes = align16(static_cast<size_t>(m) * 16);
  l.code_bytes =
      stages == 2 ? align16(static_cast<size_t>(tile_n) * (m / 2)) : 0;
  const size_t fb_bytes = stages == 2 ? align16(tile_n / 8 + 2) : 0;
  l.stage_bytes = l.lut_bytes + l.code_bytes + fb_bytes;
  l.total = l.stage + stages * l.stage_bytes;
  return l;
}

struct Plan {
  int stages;
  int digit_bits;
  size_t smem;
};

// Bits of the largest live sum, M*255: the radix select's key width.
__host__ __device__ inline int sum_bits(int m) {
  int b = 0;
  while ((m * 255) >> b) ++b;
  return b;
}

// Two prefetched stages at the widest digit if they fit; else the most
// stages (1, then 0) and the widest digit that fit. smem > kSmemLimit:
// refused.
Plan plan(int tile_n, int kc, int m) {
  const int dmax = sum_bits(m) < kMaxDigitBits ? sum_bits(m) : kMaxDigitBits;
  Plan p{2, dmax, layout(tile_n, kc, m, 2, dmax).total};
  for (int st = 1; st >= 0 && p.smem > kSmemLimit; --st)
    for (int d = dmax; d >= 1 && p.smem > kSmemLimit; --d)
      p = Plan{st, d, layout(tile_n, kc, m, st, d).total};
  return p;
}

// ---- TMA 1-D bulk copies completing on an mbarrier -----------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies to complete the phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global memory
// into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- block primitives ----------------------------------------------------

__device__ __forceinline__ int warp_incl_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Over the nb bins of one radix pass, finds the bin that holds the kth
// smallest counted row (1-based): writes (bin, rows in lower bins) to
// sel[0], sel[1] when the bins count at least kth rows, clears the bins
// and returns their total. Each thread owns nb/1024 consecutive bins (read
// 16 bytes at a time when they are a multiple of 4). Two block barriers.
__device__ __forceinline__ int select_bin(int* bins, int nb, int kth,
                                          int* sel, int* wtot) {
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine[kMaxPer];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) mine[i] = 0;
  if (per % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kMaxPer; i += 4) {
      if (i < per) {
        int4* p = reinterpret_cast<int4*>(bins + b0 + i);
        const int4 v = *p;
        mine[i] = v.x;
        mine[i + 1] = v.y;
        mine[i + 2] = v.z;
        mine[i + 3] = v.w;
        *p = make_int4(0, 0, 0, 0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (i < per && b0 + i < nb) {
        mine[i] = bins[b0 + i];
        bins[b0 + i] = 0;
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) sum += mine[i];
  const int incl = warp_incl_scan(sum);
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  const int wt = lane < kWarps ? wtot[lane] : 0;
  const int wincl = warp_incl_scan(wt);
  const int total = __shfl_sync(kFull, wincl, 31);
  int c = __shfl_sync(kFull, wincl - wt, warp) + incl - sum;
  if (c < kth && kth <= c + sum) {
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (c < kth && c + mine[i] >= kth) {
        sel[0] = b0 + i;
        sel[1] = c;
      }
      c += mine[i];
    }
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) stream_topk_prune_kernel(
    const uint8_t* __restrict__ table,   // (G, M, 16)
    const uint8_t* __restrict__ codes,   // (nlist, cap, M/2), in place
    const int32_t* __restrict__ probes,  // (G,)
    const int32_t* __restrict__ sizes,   // (nlist,)
    const uint8_t* __restrict__ fbits,   // (nlist, W) or null
    const float* __restrict__ bounds,    // (G,)
    const float* __restrict__ scales,    // (G,)
    const float* __restrict__ biases,    // (G,)
    int m, int cap, int w, int tile_n, int n_tiles, int kc, int gpq,
    int stages, int run_stages, int digit_bits, int vec,
    int32_t* __restrict__ out_vals,
    int32_t* __restrict__ out_slots, int32_t* __restrict__ out_skipped) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(tile_n, kc, m, stages, digit_bits);
  stages = run_stages;  // <= the layout's
  int* sel = reinterpret_cast<int*>(smem);
  int2* s_pf = reinterpret_cast<int2*>(smem + 16);  // warp 0's, 2 buffers
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + 32);
  int* counts = reinterpret_cast<int*>(smem + l.counts);  // or warp totals
  int32_t* vals = reinterpret_cast<int32_t*>(smem + l.vals);
  int* bins = reinterpret_cast<int*>(smem + l.bins);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(smem + l.cand);
  float* dist = reinterpret_cast<float*>(smem + l.dist);  // cand's distances
  float* runs = reinterpret_cast<float*>(smem + l.run);   // 2 x kc
  uint8_t* stage_buf = smem + l.stage;

  const int q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mh = m / 2;
  const int nchunk = (tile_n + kThreads - 1) / kThreads;
  const int bits = sum_bits(m);

  // the window: lane i of every warp holds group win + i of this query
  int win = -32, w_probe = -1, w_size = 0;
  float w_bound = CUDART_INF_F, w_scale = 0.0f, w_bias = 0.0f;
  auto load_window = [&](int base) {
    win = base;
    const int gi = base + lane;
    w_probe = -1;
    w_size = 0;
    w_bound = CUDART_INF_F;
    if (gi < gpq) {
      const int g = q * gpq + gi;
      w_probe = probes[g];
      w_bound = bounds[g];
      w_scale = scales[g];
      w_bias = biases[g];
      if (w_probe >= 0) w_size = sizes[w_probe];
    }
  };
  // a step is (x, y) = (group of the query, tile); (gpq, 0) is the end
  auto next = [&](int2 s) {
    return s.y + 1 < n_tiles ? make_int2(s.x, s.y + 1) : make_int2(s.x + 1, 0);
  };
  auto before = [](int2 a, int2 b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  };
  // the first step at or after s that passes the decision at thr (the end
  // if none); leaves the window on that step's group
  auto find = [&](int2 s, float thr) {
    while (s.x < gpq) {
      if (s.x < win || s.x >= win + 32) load_window(s.x);
      const unsigned pass = __ballot_sync(
          kFull, win + lane >= s.x && w_probe >= 0 && w_bound < thr);
      if (pass) {
        const int gp = win + __ffs(pass) - 1;
        return gp == s.x ? s : make_int2(gp, 0);
      }
      s = make_int2(win + 32, 0);
    }
    return make_int2(gpq, 0);
  };
  // group data of step s, whose group the window holds
  struct Step {
    int g, t, lid, live;
    float scale, bias;
  };
  auto step_of = [&](int2 s) {
    Step st;
    const int src = s.x - win;
    st.g = q * gpq + s.x;
    st.t = s.y;
    st.lid = __shfl_sync(kFull, w_probe, src);
    st.live = min(max(__shfl_sync(kFull, w_size, src) - st.t * tile_n, 0),
                  tile_n);
    st.scale = __shfl_sync(kFull, w_scale, src);
    st.bias = __shfl_sync(kFull, w_bias, src);
    return st;
  };
  // one thread copies a step's LUT (and, with two stages, its live code
  // rows and filter bytes, rounded up to 16 bytes: the launcher checked
  // that the tile and the filter row hold them) into stage `into`
  auto issue = [&](int into, const Step& st) {
    if (tid != 0) return;
    uint8_t* dst = stage_buf + into * l.stage_bytes;
    const int slot0 = st.t * tile_n;
    const bool rows_too = stages == 2 && st.live > 0;
    const unsigned code_b = rows_too ? (st.live * mh + 15) & ~15 : 0;
    const unsigned fb_b =
        rows_too && fbits
            ? ((((slot0 + st.live - 1) >> 3) - (slot0 >> 3) + 1) + 15) & ~15
            : 0;
    mbar_expect(&bar[into], m * 16 + code_b + fb_b);
    bulk_copy(dst, table + static_cast<size_t>(st.g) * m * 16, m * 16,
              &bar[into]);
    if (code_b)
      bulk_copy(dst + l.lut_bytes,
                codes + (static_cast<size_t>(st.lid) * cap + slot0) * mh,
                code_b, &bar[into]);
    if (fb_b)
      bulk_copy(dst + l.lut_bytes + l.code_bytes,
                fbits + static_cast<size_t>(st.lid) * w + (slot0 >> 3), fb_b,
                &bar[into]);
  };
  // every thread keeps each stage's phase and whether a copy into it is
  // in flight, and waits for every copy in issue order
  unsigned phase[2] = {0, 0};
  bool pending[2] = {false, false};
  auto wait = [&](int st) {
    mbar_wait(&bar[st], phase[st]);
    phase[st] ^= 1;
    pending[st] = false;
  };

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  for (int i = tid; i < kc; i += kThreads) runs[i] = CUDART_INF_F;
  for (int i = tid; i < (1 << digit_bits); i += kThreads) bins[i] = 0;
  float thr = CUDART_INF_F;
  int par = 0;  // runs[par * kc ..] holds the running top-kc
  // step pf's operands are in (or on their way to) stage pf_stage, the
  // stage the last scanned step did not use
  const int2 end = make_int2(gpq, 0);
  int pf_stage = 0;
  int2 pf = stages == 2 ? find(make_int2(0, 0), thr) : end;
  __syncthreads();
  if (pf.x < gpq) {
    issue(pf_stage, step_of(pf));
    pending[pf_stage] = true;
  }

  int2 done = make_int2(0, 0);  // the steps before have their outputs
  for (;;) {
    const int2 s = find(done, thr);
    // the steps skipped on the way emit sentinels; no barrier, since the
    // threshold cannot change
    for (int2 k = done; before(k, s); k = next(k)) {
      const int src = k.x - win;
      const int probe = src >= 0 ? __shfl_sync(kFull, w_probe, src)
                                 : probes[q * gpq + k.x];
      const size_t tile_out =
          static_cast<size_t>(q * gpq + k.x) * n_tiles + k.y;
      for (int i = tid; i < kc; i += kThreads) {
        out_vals[tile_out * kc + i] = kAccSentinel;
        out_slots[tile_out * kc + i] = -1;
      }
      if (tid == 0) out_skipped[tile_out] = probe >= 0 ? 1 : 0;
    }
    if (s.x >= gpq) break;
    const Step st = step_of(s);
    const int cur = pf_stage;
    if (stages > 0) {
      if (pf.x != s.x || pf.y != s.y) {  // not prefetched
        if (pending[cur]) wait(cur);     // a wasted prefetch
        issue(cur, st);
        pending[cur] = true;
      }
      wait(cur);
    }
    // warp 0 alone looks ahead and thread 0 copies; the others start on
    // the tile and learn the target after the step's last barrier
    pf_stage = stages == 2 ? cur ^ 1 : 0;
    if (stages == 2 && warp == 0) {
      const int2 nx = find(next(s), thr);
      if (lane == 0) s_pf[par] = nx;
      if (nx.x < gpq) {
        const Step ps = step_of(nx);
        issue(pf_stage, ps);
      }
    }

    // 1. the tile's sums and the first radix pass's histogram
    const size_t tile_out = static_cast<size_t>(st.g) * n_tiles + st.t;
    const int slot0 = st.t * tile_n;
    const uint8_t* lut = stages > 0
                             ? stage_buf + cur * l.stage_bytes
                             : table + static_cast<size_t>(st.g) * m * 16;
    const uint8_t* rows =
        stages == 2 ? lut + l.lut_bytes
                    : codes + (static_cast<size_t>(st.lid) * cap + slot0) * mh;
    const uint8_t* fb =
        !fbits        ? nullptr
        : stages == 2 ? lut + l.lut_bytes + l.code_bytes
                      : fbits + static_cast<size_t>(st.lid) * w + (slot0 >> 3);
    const int fbit0 = slot0 & 7;
    int rb = bits;
    int wd = min(digit_bits, rb);
    for (int r = tid; r < tile_n; r += kThreads) {
      int32_t val = kAccSentinel;
      bool ok = r < st.live;
      if (ok && fb) ok = (fb[(fbit0 + r) >> 3] >> ((fbit0 + r) & 7)) & 1;
      if (ok) {
        val = repro_cuda::row_sum(rows + static_cast<size_t>(r) * mh, lut,
                                  mh, vec);
        atomicAdd(&bins[val >> (rb - wd)], 1);
      }
      vals[r] = val;
    }
    __syncthreads();

    // 2. radix select: v*, the kc-th smallest sum (ACC_SENTINEL when fewer
    //    than kc rows are live), and `below`, the rows under it
    int kth = kc, prefix = 0, below = 0, vstar;
    for (;;) {
      const int total = select_bin(bins, 1 << wd, kth, sel, counts);
      if (total < kth) {  // first pass only: fewer than kc live rows
        vstar = kAccSentinel;
        below = total;
        break;
      }
      prefix = (prefix << wd) | sel[0];
      below += sel[1];
      kth -= sel[1];
      rb -= wd;
      if (rb == 0) {
        vstar = prefix;
        break;
      }
      wd = min(digit_bits, rb);
      for (int r = tid; r < tile_n; r += kThreads) {
        const int32_t v = vals[r];
        if (v != kAccSentinel && (v >> rb) == prefix)
          atomicAdd(&bins[(v >> (rb - wd)) & ((1 << wd) - 1)], 1);
      }
      __syncthreads();
    }

    // 3. compaction in slot order: rows under v* to [0, below), rows equal
    //    to v* from `below` on, the lowest slots first, until kc; with each
    //    key its dequantized distance
    for (int c = 0; c < nchunk; ++c) {
      const int r = c * kThreads + tid;
      const int32_t v = r < tile_n ? vals[r] : 0;
      const unsigned bl = __ballot_sync(kFull, r < tile_n && v < vstar);
      const unsigned be = __ballot_sync(kFull, r < tile_n && v == vstar);
      if (lane == 0)
        counts[c * kWarps + warp] = __popc(bl) | (__popc(be) << 16);
    }
    __syncthreads();
    // packed counts, rows under v* in the low half and equal in the high,
    // one entry per (chunk, warp), chunk-major: each warp scans them 32 at
    // a time (4 chunks) and takes its own entries' exclusive prefixes
    const unsigned below_lane = (1u << lane) - 1;
    int carry = 0;
    for (int b = 0; b < nchunk * kWarps; b += 32) {
      const int x = b + lane < nchunk * kWarps ? counts[b + lane] : 0;
      const int incl = warp_incl_scan(x);
      const int excl = carry + incl - x;
      carry += __shfl_sync(kFull, incl, 31);
#pragma unroll
      for (int k = 0; k < 32 / kWarps; ++k) {
        const int c = b / kWarps + k;
        const int before = __shfl_sync(kFull, excl, k * kWarps + warp);
        const int r = c * kThreads + tid;
        const int32_t v = c < nchunk && r < tile_n ? vals[r] : 0;
        const bool lt = c < nchunk && r < tile_n && v < vstar;
        const bool eq = c < nchunk && r < tile_n && v == vstar;
        const unsigned bl = __ballot_sync(kFull, lt);
        const unsigned be = __ballot_sync(kFull, eq);
        int pos = kc;
        if (lt) pos = (before & 0xffff) + __popc(bl & below_lane);
        if (eq) pos = below + (before >> 16) + __popc(be & below_lane);
        if (pos < kc) {
          cand[pos] = repro_cuda::slot_key(v, slot0 + r);
          dist[pos] =
              v == kAccSentinel
                  ? CUDART_INF_F
                  : __fadd_rn(__fmul_rn(st.scale, static_cast<float>(v)),
                              st.bias);
        }
      }
    }
    __syncthreads();

    // 4. by rank, one element to 8 lanes, each counting an eighth: the
    //    tile's top-kc in key order to the outputs (e < kc), and the new
    //    running top-kc, the kc smallest of (run ++ dist), each element
    //    placed by the count of elements before it (ties: run first, then
    //    index order)
    const float* run_old = runs + par * kc;
    float* run_new = runs + (par ^ 1) * kc;
    const int part = tid & 7;
    for (int e0 = 0; e0 < 3 * kc; e0 += kThreads / 8) {
      const int e = e0 + (tid >> 3);
      int n = 0;
      unsigned long long key = 0;
      float x = 0.0f;
      if (e < kc) {
        key = cand[e];
        for (int j = part; j < kc; j += 8) n += cand[j] < key;
      } else if (e < 3 * kc) {
        const int i = e - kc;  // index in run ++ dist
        x = i < kc ? run_old[i] : dist[i - kc];
        for (int j = part; j < kc; j += 8) {
          const float y = run_old[j], z = dist[j];
          n += (y < x || (y == x && j < i)) +
               (z < x || (z == x && kc + j < i));
        }
      }
      n += __shfl_xor_sync(kFull, n, 1);
      n += __shfl_xor_sync(kFull, n, 2);
      n += __shfl_xor_sync(kFull, n, 4);
      if (part == 0 && e < kc) {
        const int32_t val = static_cast<int32_t>(key >> 32);
        out_vals[tile_out * kc + n] = val;
        out_slots[tile_out * kc + n] =
            val == kAccSentinel ? -1 : static_cast<int32_t>(key & 0xffffffffu);
      } else if (part == 0 && e < 3 * kc && n < kc) {
        run_new[n] = x;
      }
    }
    if (tid == 0) out_skipped[tile_out] = 0;
    // the new running top-kc and the prefetch target are published
    __syncthreads();
    par ^= 1;
    thr = runs[par * kc + kc - 1];
    if (stages == 2) {
      pf = s_pf[par ^ 1];
      pending[pf_stage] = pf.x < gpq;
    }
    done = next(s);
  }
  // no copy may land after the CTA exits
  for (int st = 0; st < 2; ++st)
    if (pending[st]) wait(st);
}

}  // namespace

// Shared memory (bytes) one CTA needs at (tile_n, kc, M): the wrapper
// checks it against the card's limit before launching.
extern "C" long long repro_fastscan_stream_topk_prune_smem(int tile_n, int kc,
                                                           int m) {
  return static_cast<long long>(plan(tile_n, kc, m).smem);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_fastscan_stream_topk_prune(
    const void* table, const void* codes, const void* probes,
    const void* sizes, const void* fbits, const void* bounds,
    const void* scales, const void* biases, int g, int m, int cap, int w,
    int tile_n, int kc, int gpq, void* out_vals, void* out_slots,
    void* out_skipped, void* stream) {
  const Plan p = plan(tile_n, kc, m);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int mh = m / 2;
  // the bulk copies need 16-byte aligned ends: every tile's rows, and the
  // filter bytes of every tile, or else the codes are read in place; the
  // LUTs, or else they are read in place too
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  int run_stages = p.stages;
  if (run_stages == 2 &&
      !(al16(codes) && (static_cast<long long>(cap) * mh) % 16 == 0 &&
        (tile_n * mh) % 16 == 0 &&
        (fbits == nullptr ||
         (al16(fbits) && w % 16 == 0 && tile_n % 128 == 0))))
    run_stages = 1;
  if (!al16(table)) run_stages = 0;
  // staged rows start at multiples of mh bytes of a 16-byte aligned stage
  const int vec = run_stages == 2 ? ((mh % 8 == 0) ? 8 : (mh % 4 == 0) ? 4 : 1)
                                  : repro_cuda::load_width(codes, mh);
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_topk_prune_kernel<<<g / gpq, kThreads, p.smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(probes), static_cast<const int32_t*>(sizes),
      static_cast<const uint8_t*>(fbits), static_cast<const float*>(bounds),
      static_cast<const float*>(scales), static_cast<const float*>(biases), m,
      cap, w, tile_n, cap / tile_n, kc, gpq, p.stages, run_stages,
      p.digit_bits, vec,
      static_cast<int32_t*>(out_vals), static_cast<int32_t*>(out_slots),
      static_cast<int32_t*>(out_skipped));
  return static_cast<int>(cudaGetLastError());
}
