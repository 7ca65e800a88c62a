// K6: grouped 4-bit ADC as a one-hot matrix product on the tensor cores,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fastscan_kernel.py::
// fastscan_onehot_mxu_grouped (Pallas body _onehot_mxu_grouped_kernel:
// the group's (1, M*16) LUT row contracted with one-hot code planes on the
// MXU). Computes the same function as K5:
//   out[g, n] = sum_m LUT[g, m, nibble_m(codes[g, n])]   (int32)
// over a gathered (G, N, M/2) u8 copy whose N is a multiple of the tile.
//
// Formulation (fastscan_mma_flat.cuh): u8 x u8 -> s32 mma.sync.m16n8k32,
// one k-step a packed code byte (two sub-spaces). A is the one-hot of 16
// code rows, built in registers; B holds the group's LUT bytes in all 8
// columns (a group has one query, so 1/8 of the product is useful, and
// every lane reads the same words without a select); column 0 of C is the
// 16 rows' sums, which lanes with t == 0 hold (c[0] for row g, c[2] for
// row g + 8). Exact in s32.
//
// Bound on the H100: memory, as K5. The copy is read once and the sums
// written once; the useful work is M look-ups and adds a row.
//
// Design:
//   - units are (group, chunk of 128 RB rows); persistent CTAs of 8 warps
//     (as many as are resident) walk them, each warp 16 RB rows, so that a
//     warp runs RB independent MMAs a k-step;
//   - a ring of cp.async stages (4, or 3 at a large M) holds each unit's
//     LUT (once a unit) beside its code chunk, one barrier a unit;
//   - k runs in onehot_pair's order, in which a lane holds one nibble of
//     each row: its two one-hot words of a row are one byte permute and
//     one 64-bit shift, after a funnel shift and a lop3 for four code
//     bytes; B's two words are then adjacent in the LUT as it lies in
//     memory, one 8-byte shared-memory load a k-step shared by the RB MMAs
//     (a broadcast: every lane t of the warp reads one address); nothing
//     of the LUT is held in registers, so any M takes the same code;
//   - the sums go through a shared-memory double buffer and leave as
//     16-byte streaming stores while the next unit computes.
// The chunks do not depend on tile_n: every row of a group uses one LUT,
// so any split of the rows gives the same sums. RB is 16, 8, 4, 2 or 1:
// the largest whose ring fits (M = 2 .. 964 fit with 4 or 3 stages; M =
// 1024 does not), then halved while the units would not fill every SM
// twice. Longer units spread the barrier, the prefetch and the epilogue
// of a unit over more MMAs (2,048 rows at M = 16).
#include <algorithm>

#include "fastscan_mma_flat.cuh"

namespace {

using namespace repro_cuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Byte offsets: the staged sums (two buffers of a chunk's rows), then the
// ring; a stage holds the unit's LUT and its code chunk.
struct Layout {
  int rb, stages;
  size_t lut, stage, ring, total;
};

__host__ __device__ inline Layout layout(int m, int rb, int stages) {
  Layout l;
  const size_t rows = 16 * kWarps * static_cast<size_t>(rb);
  l.rb = rb;
  l.stages = stages;
  l.lut = align16(16 * static_cast<size_t>(m));
  l.stage = l.lut + align16(rows * (m / 2));
  l.ring = 2 * rows * 4;
  l.total = l.ring + stages * l.stage;
  return l;
}

// The largest RB (then the most stages) whose buffers fit; total >
// kSmemLimit: refused (RB = 1 with 3 stages does not fit).
__host__ __device__ inline Layout plan(int m) {
  for (int rb = 16; rb >= 1; rb /= 2)
    for (int stages = 4; stages >= 3; --stages) {
      const Layout l = layout(m, rb, stages);
      if (l.total <= kSmemLimit) return l;
    }
  return layout(m, 1, 3);
}

// Unit u of the walk: group u / chunks, its rows row0 .. row0 + rows - 1.
struct Unit {
  int grp, row0, rows;
};

template <int RB>
__global__ void __launch_bounds__(kThreads) onehot_mma_grouped_kernel(
    const uint8_t* __restrict__ table,  // (G, M, 16)
    const uint8_t* __restrict__ codes,  // (G, N, M/2), gathered
    int m, int n, int chunks, int n_units, int stages,
    int32_t* __restrict__ out) {        // (G, N)
  constexpr int kRows = 16 * kWarps * RB;  // code rows of a unit
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(m, RB, stages);
  int32_t* staged = reinterpret_cast<int32_t*>(smem);
  uint8_t* ring = smem + l.ring;
  const int mh = m / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // lane t's nibble (low for t < 2) and first code (8 (t & 1)), for
  // nibble_shifts
  const uint32_t rot = t < 2 ? 29u : 1u, c0x = (t & 1) ? 0x40404040u : 0u;
  const int step = gridDim.x;

  auto decode = [&](int u) {
    Unit d;
    d.grp = u / chunks;
    d.row0 = (u - d.grp * chunks) * kRows;
    d.rows = min(kRows, n - d.row0);
    return d;
  };
  auto load = [&](const Unit& d, int s) {
    uint8_t* dst = ring + s * l.stage;
    copy_async<kThreads>(dst, table + static_cast<size_t>(d.grp) * m * 16,
                         16 * static_cast<size_t>(m));
    copy_async<kThreads>(
        dst + l.lut,
        codes + (static_cast<size_t>(d.grp) * n + d.row0) * mh,
        static_cast<size_t>(d.rows) * mh);
  };
  // unit d's staged sums (buffer buf) to the output
  auto epilogue = [&](const Unit& d, int buf) {
    const int32_t* st = staged + buf * kRows;
    const size_t base = static_cast<size_t>(d.grp) * n + d.row0;
    int32_t* dst = out + base;
    const bool vec = (base & 3) == 0;  // out itself is 16-byte aligned
    for (int r4 = 4 * tid; r4 < d.rows; r4 += 4 * kThreads) {
      const int4 v = *reinterpret_cast<const int4*>(st + r4);
      if (vec && r4 + 4 <= d.rows) {
        __stcs(reinterpret_cast<int4*>(dst + r4), v);
      } else {
        __stcs(dst + r4, v.x);
        if (r4 + 1 < d.rows) __stcs(dst + r4 + 1, v.y);
        if (r4 + 2 < d.rows) __stcs(dst + r4 + 2, v.z);
        if (r4 + 3 < d.rows) __stcs(dst + r4 + 3, v.w);
      }
    }
  };

  // the ring: unit i of this CTA (blockIdx.x + i * step) in stage i % stages
  for (int s = 0; s < stages - 1; ++s) {
    const int u = blockIdx.x + s * step;
    if (u < n_units) load(decode(u), s);
    cp_async_commit();
  }
  int i = 0;
  Unit prev;
  for (int u = blockIdx.x; u < n_units; u += step, ++i) {
    if (stages == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    // unit i's LUT and codes are in, the stage of unit i - 1 is free, and
    // the sums of unit i - 1 are staged
    __syncthreads();
    const int nu = u + (stages - 1) * step;
    if (nu < n_units) load(decode(nu), (i + stages - 1) % stages);
    cp_async_commit();
    if (i > 0) epilogue(prev, (i - 1) & 1);

    const Unit cur = decode(u);
    const int warp_row = 16 * RB * warp;  // the warp's first row
    if (warp_row < cur.rows) {  // else the warp's rows are all past N
      const uint8_t* st = ring + (i % stages) * l.stage;
      // lane t's b0, b1 of byte j: LUT words 8j + 2t and 8j + 2t + 1
      const uint2* lw = reinterpret_cast<const uint2*>(st) + t;
      const uint8_t* rows_g = st + l.lut + (warp_row + g) * mh;
      int acc[RB][4];
#pragma unroll
      for (int b = 0; b < RB; ++b)
        acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0;
      uint32_t x[RB], x8[RB];  // nibble shifts of rows g and g + 8
      auto kstep = [&](int j, int k) {
        const uint2 bv = lw[4 * j];
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          uint32_t a0, a1, a2, a3;
          onehot_pair(x[b], k, a0, a2);
          onehot_pair(x8[b], k, a1, a3);
          mma_u8_m16n8k32(acc[b], a0, a1, a2, a3, bv.x, bv.y);
        }
      };
      if (mh % 4 == 0) {  // rows start at multiples of 4 bytes
        for (int j = 0; j < mh; j += 4) {
#pragma unroll
          for (int b = 0; b < RB; ++b) {
            x[b] = nibble_shifts(
                *reinterpret_cast<const uint32_t*>(rows_g + 16 * b * mh + j),
                rot, c0x);
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
      // column 0 of C: rows g and g + 8 of each row block
      if (t == 0) {
        int32_t* sum = staged + (i & 1) * kRows + warp_row + g;
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          sum[16 * b] = acc[b][0];
          sum[16 * b + 8] = acc[b][2];
        }
      }
    }
    prev = cur;
  }
  if (i > 0) {
    __syncthreads();
    epilogue(prev, (i - 1) & 1);
  }
}

template <int RB>
cudaError_t launch(const uint8_t* table, const uint8_t* codes, int g, int m,
                   int n, const Layout& l, int32_t* out,
                   cudaStream_t stream) {
  const auto kernel = onehot_mma_grouped_kernel<RB>;
  long long resident = 0;
  const cudaError_t err = resident_ctas(kernel, kThreads, l.total, resident);
  if (err != cudaSuccess) return err;
  const int rows = 16 * kWarps * RB;
  const int chunks = (n + rows - 1) / rows;
  const long long n_units = static_cast<long long>(g) * chunks;
  const long long grid = std::min(n_units, resident);
  // unit indices, and the prefetch's up to 3 grids past them, stay ints
  if (n_units + 4 * grid >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreads, l.total, stream>>>(
      table, codes, m, n, chunks, static_cast<int>(n_units), l.stages, out);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one CTA of the launch at M sub-spaces takes (more
// than the card's limit when none fits): the wrapper checks it before
// launching, and mxu_kernel.smem_bytes mirrors it.
extern "C" long long repro_fastscan_onehot_mma_grouped_smem(int m) {
  return static_cast<long long>(plan(m).total);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// tile_n (dividing n) is the reference's tile; the kernel's chunks do not
// depend on it.
extern "C" int repro_fastscan_onehot_mma_grouped(const void* table,
                                                 const void* codes, int g,
                                                 int m, int n, int tile_n,
                                                 void* out, void* stream) {
  (void)tile_n;
  Layout l = plan(m);
  if (l.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // fewer rows a unit where the units would not fill every SM twice
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  while (l.rb > 1) {
    const long long rows = 16LL * kWarps * l.rb;
    if (static_cast<long long>(g) * ((n + rows - 1) / rows) >= 2LL * sms)
      break;
    l = layout(m, l.rb / 2, l.stages);
  }
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;
  if (l.rb == 16) err = launch<16>(t, c, g, m, n, l, o, s);
  if (l.rb == 8) err = launch<8>(t, c, g, m, n, l, o, s);
  if (l.rb == 4) err = launch<4>(t, c, g, m, n, l, o, s);
  if (l.rb == 2) err = launch<2>(t, c, g, m, n, l, o, s);
  if (l.rb == 1) err = launch<1>(t, c, g, m, n, l, o, s);
  return static_cast<int>(err);
}
