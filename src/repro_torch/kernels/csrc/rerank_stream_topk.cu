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
// Bound on the H100: memory. Each candidate row is D*4 bytes read once for
// 2*D flops; rows are a true gather (random ids into the (N, D) base), so
// the read pattern is one 512-byte row per candidate at D=128.
//
// Design (first version, simple on purpose; a later PR makes it fast):
//   - one CTA per query, walking its candidate chunks in order;
//   - one warp per candidate row: each lane reads 16-byte float4s of the
//     row, the dot is reduced across the warp by shuffles;
//   - the running top-k lives in shared memory. Distances are >= 0 or
//     +inf, so their f32 bit patterns order as u32, and the 64-bit key
//     (bits << 32) | index-in-(running ++ chunk) sorts in exactly
//     _merge_topk's first-occurrence order; a shared-memory bitonic sort
//     of the k + tile_r keys (padded to a power of two) does the merge.
// The dot and ||q||^2 are summed in another order than torch's reduction,
// so results agree with the plain version within an f32 tolerance, not
// bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// lane-strided dot of a (shared) and b (global), reduced across the warp
__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b, int d,
                                          bool vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    for (int i = lane * 4; i < d; i += 128) {
      const float4 x = *reinterpret_cast<const float4*>(b + i);
      const float4 y = *reinterpret_cast<const float4*>(a + i);
      acc += y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
    }
  } else {
    for (int i = lane; i < d; i += 32) acc += a[i] * b[i];
  }
  return warp_sum(acc);
}

__global__ void __launch_bounds__(kThreads) rerank_kernel(
    const float* __restrict__ base,      // (N, D), in place
    const float* __restrict__ q,         // (Q, D)
    const int32_t* __restrict__ cand,    // (Q, Rp), -1 = pad
    const float* __restrict__ xn,        // (Q, Rp) precomputed ||x||^2
    int n, int d, int rp, int tile_r, int k, int pow2, int vec4,
    float* __restrict__ out_vals, int32_t* __restrict__ out_pos) {
  extern __shared__ unsigned long long keys[];            // pow2
  float* qs = reinterpret_cast<float*>(keys + pow2);      // d
  float* cdist = qs + d;                                  // tile_r
  float* run_v = cdist + tile_r;                          // k
  float* new_v = run_v + k;                               // k
  int32_t* run_p = reinterpret_cast<int32_t*>(new_v + k); // k
  int32_t* new_p = run_p + k;                             // k

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < d; i += blockDim.x) qs[i] = q[static_cast<size_t>(qi) * d + i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    run_v[i] = INFINITY;
    run_p[i] = -1;
  }
  __syncthreads();
  // every warp reduces ||q||^2 in the same order, so all hold the same value
  const float qn = warp_dot(qs, qs, d, vec4, lane);
  const int32_t* qcand = cand + static_cast<size_t>(qi) * rp;
  const float* qxn = xn + static_cast<size_t>(qi) * rp;

  for (int c = 0; c * tile_r < rp; ++c) {
    for (int j = warp; j < tile_r; j += kWarps) {
      const int p = c * tile_r + j;
      const int cid = qcand[p];
      float dist = INFINITY;
      if (cid >= 0 && cid < n) {
        const float dot = warp_dot(qs, base + static_cast<size_t>(cid) * d, d, vec4, lane);
        const float v = (qn - 2.0f * dot) + qxn[p];
        dist = v > 0.f ? v : 0.f;  // clamp; also maps -0.0 to +0.0
      }
      if (lane == 0) cdist[j] = dist;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < pow2; i += blockDim.x) {
      unsigned long long key = ~0ull;
      if (i < k)
        key = (static_cast<unsigned long long>(__float_as_uint(run_v[i])) << 32) | i;
      else if (i < k + tile_r)
        key = (static_cast<unsigned long long>(__float_as_uint(cdist[i - k])) << 32) | i;
      keys[i] = key;
    }
    __syncthreads();
    for (int k2 = 2; k2 <= pow2; k2 <<= 1) {
      for (int j = k2 >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < pow2; i += blockDim.x) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = keys[i], b = keys[ixj];
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
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const unsigned long long key = keys[i];
      const int src = static_cast<int>(key & 0xffffffffu);
      new_v[i] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      new_p[i] = src < k ? run_p[src] : c * tile_r + (src - k);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      run_v[i] = new_v[i];
      run_p[i] = new_p[i];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float v = run_v[i];
    out_vals[static_cast<size_t>(qi) * k + i] = v;
    out_pos[static_cast<size_t>(qi) * k + i] = isfinite(v) ? run_p[i] : -1;
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// shared memory of one CTA: the keys, then q, the chunk's distances and
// four k-long arrays of 4 bytes (rerank_kernel.py::smem_bytes mirrors it)
size_t smem_bytes(int d, int tile_r, int k) {
  return static_cast<size_t>(next_pow2(k + tile_r)) * 8
         + (static_cast<size_t>(d) + tile_r + 4 * k) * 4;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_rerank_stream_topk(
    const void* base, const void* q, const void* cand, const void* xn, int nq,
    int n, int d, int rp, int tile_r, int k, void* out_vals, void* out_pos,
    void* stream) {
  const int pow2 = next_pow2(k + tile_r);
  const size_t smem = smem_bytes(d, tile_r, k);
  const int vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(base) % 16 == 0);
  cudaError_t err = cudaFuncSetAttribute(
      rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rerank_kernel<<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(q),
      static_cast<const int32_t*>(cand), static_cast<const float*>(xn), n, d,
      rp, tile_r, k, pow2, vec4, static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_pos));
  return static_cast<int>(cudaGetLastError());
}
