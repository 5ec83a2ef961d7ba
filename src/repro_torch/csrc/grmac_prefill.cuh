// GR-MAC matmul, prefill design: M from the switch up, the values dot on
// the tensor cores.
//
// Taken only where both formats' values are exact in bf16 (n_man <= 7; the
// wrapper routes other formats to grmac_decode.cuh). Then every product is
// exact, and an n_r-deep sum of FP6_E3M2 x FP4_E2M1 products (multiples of
// 2^-13 below 2^7) is exact in the f32 accumulator, as it is on the TPU's
// MXU, which runs this dot in bf16 too. fp8 MMA is not used: Hopper keeps
// fewer accumulator bits there.
//
// A block computes a 64 x 64 output tile with 8 warps (2 x 4, each 32 x
// 16: 2 x 2 mma.sync.m16n8k16 tiles): the per-stage work of quantizing x
// and of the epilogue is latency-bound, so it is spread over as many warps
// as the tile allows. K runs in stages of 32 codes:
//  * the packed codes of a stage (1 or 2 KB) arrive by cp.async, three
//    stages in a ring, two in flight;
//  * x of the next stage is loaded into registers while this stage's MMAs
//    run, then divided by sx, quantized and stored as bf16 (ldmatrix rows
//    of 80 bytes: no bank conflicts); row granularity sums the gains of
//    each (row, analog column) there, unit granularity stores them as a
//    second bf16 tile;
//  * B fragments are decoded in registers from the codes through a
//    256-entry table in shared memory (a byte of two 4-bit codes -> two
//    bf16 values);
//  * after each n_r-deep analog column the accumulator fragments go
//    through den -> ADC -> renormalize into a separate f32 accumulator and
//    are reset. Row granularity's den is summed once per (row, analog
//    column) as x is staged. Unit granularity's den = gx @ gw is a second
//    MMA: gains are
//    powers of two (<= 2^7 and <= 2^3 on the main formats), so it is exact.
// Where the tiles make fewer blocks than the 132 SMs (768-wide projections
// at M = 512 make 96), a thread-block cluster of `splits` blocks splits K
// at analog-column boundaries; the blocks leave their partial tiles in
// shared memory and cluster rank 0 sums them in K order through
// distributed shared memory (no atomics), then stores.
// The sanitizing instantiation (SAN) checks each output fragment's v in
// the column epilogue (real rows and columns only); row granularity's
// span of each (row, analog column) where x is staged, in the blocks of
// the first column tile only (the others stage the same rows again); unit
// granularity's span of E(x) + E(w) per (row, column) from the staged
// gain tile and the codes' gains, a loop beside the gain MMA.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "grmac_common.cuh"

namespace cg = cooperative_groups;

namespace grmac {
namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int KC = 32;        // K codes per stage
constexpr int THREADS = 256;
constexpr int APITCH = KC + 8;  // bf16 per staged x row (80 bytes)
constexpr int WSLOTS = 3;

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __float_as_uint(v) >> 16;  // exact: v is exact in bf16
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CB>
struct Smem {
  static constexpr int GPS = KC * CB / 128;  // 16-byte groups per stage
  uint16_t a[2][BM][APITCH];
  uint16_t g[2][BM][APITCH];                 // unit: the gains of x
  uint4 w[WSLOTS][GPS][BN];
  uint32_t lut[256];                          // byte -> bf16 value(s)
  uint32_t glut[256];                         // byte -> bf16 gain(s)
  float den[2][BM][2];                        // row: gain sums
  float part[BM][BN];                         // a split's partial tile
};

// The two B registers (k pairs 2t, 2t+1 and 8+2t, 9+2t of k16 step ks) of
// column c, from the stage's codes through a table.
template <int CB>
__device__ __forceinline__ void b_frag(const Smem<CB>& s, const uint32_t* tab,
                                       int slot, int ks, int c, int t,
                                       uint32_t& b0, uint32_t& b1) {
  if constexpr (CB == 4) {
    const uint4 q = s.w[slot][0][c];
    b0 = tab[((ks ? q.z : q.x) >> (8 * t)) & 255];
    b1 = tab[((ks ? q.w : q.y) >> (8 * t)) & 255];
  } else {
    const uint4 q = s.w[slot][ks][c];
    const uint32_t h0 = (((t >> 1) ? q.y : q.x) >> (16 * (t & 1))) & 0xffff;
    const uint32_t h1 = (((t >> 1) ? q.w : q.z) >> (16 * (t & 1))) & 0xffff;
    b0 = tab[h0 & 255] | (tab[h0 >> 8] << 16);
    b1 = tab[h1 & 255] | (tab[h1 >> 8] << 16);
  }
}

// The sanitizer's running exponent-sum span of unit granularity, per
// output fragment element, over one analog column.
struct UnitSpan {
  int hi[2][2][4], lo[2][2][4];
};

// The exponent of a power of two held as bf16 bits.
__device__ __forceinline__ int bf16_exp(uint32_t bits) {
  return (int)((bits >> 7) & 0xff) - 127;
}

// Folds the 16 K codes of k16 step ks into the unit spans: E(x) from the
// staged gain tile, E(w) from each code's gain in the table.
template <int CB>
__device__ __forceinline__ void unit_span_step(const Smem<CB>& s, int buf,
                                               int slot, int ks, int row0,
                                               int col0, int g, int t,
                                               UnitSpan& sp) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + mt * 16 + g + (i >> 1) * 8;
        const int c = col0 + nt * 8 + 2 * t + (i & 1);
        for (int kk = 0; kk < 16; ++kk) {
          const int k = ks * 16 + kk;
          uint32_t code;
          // the 16-byte group's word holding code k (no local array)
          if constexpr (CB == 4) {
            const uint4 q = s.w[slot][0][c];
            const uint32_t wd = k < 16 ? (k < 8 ? q.x : q.y)
                                       : (k < 24 ? q.z : q.w);
            code = (wd >> (4 * (k % 8))) & 15;
          } else {
            const uint4 q = s.w[slot][ks][c];
            const uint32_t wd = kk < 8 ? (kk < 4 ? q.x : q.y)
                                       : (kk < 12 ? q.z : q.w);
            code = (wd >> (8 * (kk % 4))) & 255;
          }
          const int e = bf16_exp(s.g[buf][r][k]) +
                        bf16_exp(s.glut[code] & 0xffffu);
          sp.hi[mt][nt][i] = max(sp.hi[mt][nt][i], e);
          sp.lo[mt][nt][i] = min(sp.lo[mt][nt][i], e);
        }
      }
}

template <int N_R, int GRAN, bool SAN>
__device__ __forceinline__ void column_epilogue(
    float (&acc)[2][2][4], float (&num)[2][2][4], float (&dn)[2][2][4],
    const float (*den)[2], int half, int row0, int g, const Params& p,
    int m0, int n0, int col0, int t, SanAcc& san, UnitSpan& sp) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d = 0.f;
        if constexpr (GRAN == kRow)
          d = den[row0 + mt * 16 + g + (i >> 1) * 8][half];
        if constexpr (GRAN == kUnit) d = dn[mt][nt][i];
        bool real = false;
        if constexpr (SAN)
          real = m0 + row0 + mt * 16 + g + (i >> 1) * 8 < p.M &&
                 n0 + col0 + nt * 8 + 2 * t + (i & 1) < p.N;
        acc[mt][nt][i] = __fadd_rn(
            acc[mt][nt][i],
            block_term<GRAN, N_R, SAN>(num[mt][nt][i], d, p, &san, real));
        num[mt][nt][i] = 0.f;
        dn[mt][nt][i] = 0.f;
        if constexpr (SAN && GRAN == kUnit) {
          san_span(san, sp.hi[mt][nt][i] - sp.lo[mt][nt][i], real);
          sp.hi[mt][nt][i] = -(1 << 30);
          sp.lo[mt][nt][i] = 1 << 30;
        }
      }
}

template <int N_R, int GRAN, int CB, bool SAN>
__global__ void __launch_bounds__(THREADS) prefill_kernel(const Params p) {
  __shared__ __align__(16) Smem<CB> s;
  constexpr int GPS = Smem<CB>::GPS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;   // 32 rows
  const int wn = warp & 3;    // 16 columns
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // this block's stages: its share of K in whole analog columns
  constexpr int U = N_R > KC ? N_R / KC : 1;  // stages per analog column
  const int units = p.k_store / KC / U;
  const int rank = blockIdx.z;  // the cluster spans the grid's z extent
  const int s0 = (int)((long)rank * units / p.splits) * U;
  const int ns = (int)((long)(rank + 1) * units / p.splits) * U;
  SanAcc san;
  UnitSpan usp;
  if constexpr (SAN && GRAN == kUnit) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          usp.hi[mt][nt][i] = -(1 << 30);
          usp.lo[mt][nt][i] = 1 << 30;
        }
  }

  auto fetch_w = [&](int st) {
    for (int c = tid; c < GPS * BN; c += THREADS) {
      const int gi = c / BN;
      const int cl = c - gi * BN;
      const int col = min(n0 + cl, p.N - 1);
      cp_async16(&s.w[st % WSLOTS][gi][cl],
                 p.codes + ((size_t)(st * GPS + gi) * p.N + col) * 16);
    }
  };
  fetch_w(s0);
  cp_async_commit();
  if (s0 + 1 < ns) fetch_w(s0 + 1);
  cp_async_commit();

  for (int c = tid; c < 256; c += THREADS) {
    auto val = [&](int code) { return code < p.n_codes ? __ldg(p.lut + code) : 0.f; };
    auto gain = [&](int code) { return pow2i(eff_exp(fabsf(val(code)), p.w_e_max)); };
    if constexpr (CB == 4) {
      s.lut[c] = bf16_bits(val(c & 15)) | (bf16_bits(val(c >> 4)) << 16);
      s.glut[c] = bf16_bits(gain(c & 15)) | (bf16_bits(gain(c >> 4)) << 16);
    } else {
      s.lut[c] = bf16_bits(val(c));
      s.glut[c] = bf16_bits(gain(c));
    }
  }

  // x staging: thread -> (row, quarter of the stage's 32 codes)
  const float sx = prescale(p);
  const int xrow = tid >> 2;
  const int xq4 = tid & 3;
  float xr[8];
  float den_run = 0.f;
  int emin_run = 1 << 30, emax_run = -(1 << 30);  // SAN: row spans
  // SAN: a (row, analog column)'s span, counted by one block per row
  auto row_span = [&](int emin, int emax, int j) {
    san_span(san, emax - emin,
             blockIdx.x == 0 && m0 + xrow < p.M && j < p.J);
  };
  auto load_x = [&](int st) {
    const int row = m0 + xrow;
    const int k0 = st * KC + xq4 * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xr[i] = (row < p.M && k0 + i < p.K)
                  ? __ldg(p.x + (size_t)row * p.K + k0 + i) : 0.f;
  };
  auto stage_x = [&](int st) {
    const int buf = st & 1;
    uint32_t qa[4], ga[4];
    float gsum = 0.f;
    int emin = 1 << 30, emax = -(1 << 30);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      int e0, e1;
      const float q0 = quantize_x(xr[i], sx, p, &e0);
      const float q1 = quantize_x(xr[i + 1], sx, p, &e1);
      qa[i / 2] = bf16_bits(q0) | (bf16_bits(q1) << 16);
      ga[i / 2] = bf16_bits(pow2i(e0)) | (bf16_bits(pow2i(e1)) << 16);
      gsum = __fadd_rn(__fadd_rn(gsum, pow2i(e0)), pow2i(e1));
      if constexpr (SAN && GRAN == kRow) {
        emin = min(emin, min(e0, e1));
        emax = max(emax, max(e0, e1));
      }
    }
    *reinterpret_cast<uint4*>(&s.a[buf][xrow][xq4 * 8]) =
        make_uint4(qa[0], qa[1], qa[2], qa[3]);
    if constexpr (GRAN == kUnit)
      *reinterpret_cast<uint4*>(&s.g[buf][xrow][xq4 * 8]) =
          make_uint4(ga[0], ga[1], ga[2], ga[3]);
    if constexpr (GRAN == kRow) {
      // gain sums are integers below 2^24: exact in any order
      if constexpr (N_R == 16) {  // quarters 0-1 and 2-3: an analog column each
        const float tot = __fadd_rn(gsum, __shfl_xor_sync(0xffffffffu, gsum, 1));
        if ((xq4 & 1) == 0) s.den[buf][xrow][xq4 >> 1] = tot;
        if constexpr (SAN) {
          const int lo = min(emin, __shfl_xor_sync(0xffffffffu, emin, 1));
          const int hi = max(emax, __shfl_xor_sync(0xffffffffu, emax, 1));
          if ((xq4 & 1) == 0) row_span(lo, hi, 2 * st + (xq4 >> 1));
        }
      } else {
        den_run = __fadd_rn(den_run, gsum);
        if constexpr (SAN) {
          emin_run = min(emin_run, emin);
          emax_run = max(emax_run, emax);
        }
        if (((st + 1) * KC) % N_R == 0) {  // the analog column ends here
          float tot = __fadd_rn(den_run, __shfl_xor_sync(0xffffffffu, den_run, 1));
          tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, 2));
          if (xq4 == 0) s.den[buf][xrow][0] = tot;
          den_run = 0.f;
          if constexpr (SAN) {
            int lo = min(emin_run, __shfl_xor_sync(0xffffffffu, emin_run, 1));
            int hi = max(emax_run, __shfl_xor_sync(0xffffffffu, emax_run, 1));
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, 2));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, 2));
            if (xq4 == 0) row_span(lo, hi, (st + 1) * KC / N_R - 1);
            emin_run = 1 << 30;
            emax_run = -(1 << 30);
          }
        }
      }
    }
  };
  load_x(s0);
  stage_x(s0);

  float num[2][2][4], acc[2][2][4], dn[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) num[mt][nt][i] = acc[mt][nt][i] = dn[mt][nt][i] = 0.f;

  for (int st = s0; st < ns; ++st) {
    if (st + 1 < ns) load_x(st + 1);
    cp_async_wait<1>();  // this thread's copies of stage st have landed
    __syncthreads();     // everyone's copies, x tiles and tables are visible
    if (st + 2 < ns) fetch_w(st + 2);
    cp_async_commit();
    const int buf = st & 1;
    const int slot = st % WSLOTS;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[2][4], ga[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + (lane & 15);
        const int k = ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(a[mt], &s.a[buf][r][k]);
        if constexpr (GRAN == kUnit) ldmatrix_x4(ga[mt], &s.g[buf][r][k]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = wn * 16 + nt * 8 + g;
        uint32_t b0, b1;
        b_frag<CB>(s, s.lut, slot, ks, c, t, b0, b1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(num[mt][nt], a[mt], b0, b1);
        if constexpr (GRAN == kUnit) {
          b_frag<CB>(s, s.glut, slot, ks, c, t, b0, b1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(dn[mt][nt], ga[mt], b0, b1);
        }
      }
      if constexpr (SAN && GRAN == kUnit)
        unit_span_step<CB>(s, buf, slot, ks, wm * 32, wn * 16, g, t, usp);
      if constexpr (N_R == 16) {
        if (2 * st + ks < p.J)
          column_epilogue<N_R, GRAN, SAN>(acc, num, dn, s.den[buf], ks,
                                          wm * 32, g, p, m0, n0, wn * 16, t,
                                          san, usp);
      }
    }
    if constexpr (N_R >= 32) {
      if (((st + 1) * KC) % N_R == 0 && ((st + 1) * KC) / N_R <= p.J)
        column_epilogue<N_R, GRAN, SAN>(acc, num, dn, s.den[buf], 0,
                                        wm * 32, g, p, m0, n0, wn * 16, t,
                                        san, usp);
    }
    if (st + 1 < ns) stage_x(st + 1);
  }
  if constexpr (SAN) san_flush(san, p.san);

  // the splits' partial tiles, summed by rank 0 in K (rank) order
  cg::cluster_group cluster = cg::this_cluster();
  if (p.splits > 1) {
    if (rank != 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s.part[wm * 32 + mt * 16 + g + (i >> 1) * 8]
                  [wn * 16 + nt * 8 + 2 * t + (i & 1)] = acc[mt][nt][i];
    }
    cluster.sync();
  }
  if (rank == 0) {
    const float scale = postscale(p);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = wm * 32 + mt * 16 + g + (i >> 1) * 8;
          const int c = wn * 16 + nt * 8 + 2 * t + (i & 1);
          float v = acc[mt][nt][i];
          for (int q = 1; q < p.splits; ++q)
            v = __fadd_rn(v, cluster.map_shared_rank(&s.part[0][0], q)[r * BN + c]);
          if (m0 + r < p.M && n0 + c < p.N)
            p.out[(size_t)(m0 + r) * p.N + n0 + c] = __fmul_rn(v, scale);
        }
  }
  if (p.splits > 1) cluster.sync();  // partial tiles outlive rank 0's reads
}

template <int N_R, int GRAN, int CB, bool SAN>
cudaError_t launch_t(Params p, cudaStream_t stream) {
  const long tiles = (long)((p.N + BN - 1) / BN) * ((p.M + BM - 1) / BM);
  const int units = p.k_store / KC / (N_R > KC ? N_R / KC : 1);
  // split K only to fill the 132 SMs, at most 8 ways (a portable cluster)
  p.splits = tiles >= 132 ? 1
             : (int)std::min<long>({8L, (long)units, (132 + tiles - 1) / tiles});
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, prefill_kernel<N_R, GRAN, CB, SAN>, p);
}

template <int N_R, int GRAN, bool SAN>
cudaError_t launch_bits(const Params& p, cudaStream_t stream) {
  return p.code_bits == 4 ? launch_t<N_R, GRAN, 4, SAN>(p, stream)
                          : launch_t<N_R, GRAN, 8, SAN>(p, stream);
}

template <int N_R, bool SAN>
cudaError_t launch_gran(const Params& p, int granularity, cudaStream_t stream) {
  switch (granularity) {
    case kConv: return launch_bits<N_R, kConv, SAN>(p, stream);
    case kRow: return launch_bits<N_R, kRow, SAN>(p, stream);
    case kUnit: return launch_bits<N_R, kUnit, SAN>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The design's launcher for one instantiation (SAN: the sanitizing one);
// grmac_prefill.cu and grmac_prefill_san.cu each compile one of the two.
template <bool SAN>
cudaError_t launch_prefill_t(const Params& p, int n_r, int granularity,
                             cudaStream_t stream) {
  switch (n_r) {
    case 16: return launch_gran<16, SAN>(p, granularity, stream);
    case 32: return launch_gran<32, SAN>(p, granularity, stream);
    case 64: return launch_gran<64, SAN>(p, granularity, stream);
    case 128: return launch_gran<128, SAN>(p, granularity, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace grmac
