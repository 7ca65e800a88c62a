// A yardstick, not a port of a TPU kernel: the card's rate of independent
// u8 x u8 -> s32 mma.sync.m16n8k32 from registers, the instruction of the
// one-hot scans K6, K7b and K7c. chip_smoke.py builds it apart from the
// kernels' library and times it beside them: a one-hot scan runs
// (rows / 16) x (M / 2) x (query tiles) of these, so their count over this
// rate is the least time its product can take.
//
// Each warp runs kChains independent accumulator chains of `iters` MMAs on
// operands held in registers (no loads, no one-hot build).
#include "../fastscan_mma_flat.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

__global__ void __launch_bounds__(kThreads) mma_rate_kernel(int iters,
                                                            int32_t* out) {
  int acc[kChains][4];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c][0] = acc[c][1] = acc[c][2] =
      acc[c][3] = 0;
  const uint32_t a = 0x01010101u * (threadIdx.x & 7), b = blockIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      repro_cuda::mma_u8_m16n8k32(acc[c], a, a + c, a ^ c, a, b, b + c);
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// MMAs one call runs: ctas x 8 warps x iters x kChains.
extern "C" long long repro_mma_rate_count(int ctas, int iters) {
  return static_cast<long long>(ctas) * (kThreads / 32) * iters * kChains;
}

// Launch on `stream` (out: ctas * 256 i32); returns cudaGetLastError().
extern "C" int repro_mma_rate(int ctas, int iters, void* out, void* stream) {
  mma_rate_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
