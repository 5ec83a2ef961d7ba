// GR-MAC matmul for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces src/repro/kernels/grmac_matmul.py::grmac_matmul_pallas, the
// Pallas TPU kernel (body _kernel, helpers _pow2, _quant_decompose, _adc).
// Its plain PyTorch version is src/repro_torch/kernels/ref.py; the wrapper
// that builds, binds and launches this file is kernels/grmac_matmul.py.
//
// What it computes: out = (M, K) @ (K, N) through the analog CIM signal
// chain. x is pre-scaled to [-1, 1] and quantized here onto fmt_x; w is
// already on the fmt_w grid. For each n_r-deep K sub-block (one analog
// column): num = xq_blk . w_blk, then by granularity
//   row:  den = sum of 2^E(xq) over the block, per row;
//         v = num * 2^e_max_x / den;  z = ADC(v) * den * 2^-e_max_x
//   unit: den = 2^E(xq) . 2^E(w) per (row, col);
//         v = num * 2^(e_max_x + e_max_w) / den;  z = ADC(v) * den / 2^(..)
//   conv: v = num / n_r;  z = ADC(v) * n_r
// with the mid-tread ADC clip(rint(v / delta) * delta, -1, 1), and the
// block terms z accumulated in K order.
//
// What bounds it on this card (H100 SXM data sheet: 3.35 TB/s HBM, 67
// TFLOP/s f32 outside the tensor cores, 989 TFLOP/s bf16 tensor cores):
// decode at M = 8 is bound by weight bytes, 551 MB of f32 w per forward of
// paper-cim-120m, which takes at least 165 us at 3.35 TB/s. At prefill
// shapes every (row, block, col) needs an epilogue of about ten f32
// operations, an IEEE division among them, beside only 2 * n_r multiply-adds
// of the values dot; the epilogue on the f32 pipe, not the dot, is then the
// likely limit.
//
// This first version only puts both on the card correctly. One block per
// (BM x BN) output tile, a loop over K in n_r-deep sub-blocks in K order,
// each sub-block staged through shared memory in chunks of at most 32 rows
// of K: the x chunk quantized with its gains, the w chunk with its gains for
// unit granularity (recovered from w, as the Pallas kernel does). Each
// thread owns TM x TN outputs and forms num (and den) by f32 FMA, then the
// epilogue, in registers. Two tile shapes: 8 x 32 for decode-sized M, so
// that N alone spreads the work over the SMs, and 64 x 64 once the grid of
// those fills the card. Not yet: wgmma/TMA for prefill, split-K for decode,
// weights in fewer bits than f32.
//
// Numerics that make the result match the plain version:
//  * 2^e is assembled from IEEE bits, never exp2f/ldexpf;
//  * the exponent comes from the f32 bits, clipped to [1, e_max], so zero
//    and f32 subnormals land in bin 1 (gain 2), and the gain is taken from
//    the quantized value (rounding can promote into the next binade);
//  * rounding is rintf (half to even), division is __fdiv_rn (IEEE), and
//    the epilogue's products and sums are __fmul_rn/__fadd_rn so no FMA
//    contraction changes a rounding. Build without -use_fast_math.
// For FP6_E3M2 x FP4_E2M1 every product is a multiple of 2^-13 and every
// n_r-deep sum fits in 18 bits, so num and den are exact in any order and
// the result equals the plain version bit for bit. Wider formats lose that
// exactness; there the order of the FMA chain may move the last bits.

#include <cuda_runtime.h>

#include <cmath>

namespace {

enum Granularity { kConv = 0, kRow = 1, kUnit = 2 };

struct Params {
  const float* x;
  const float* w;
  float* out;
  int M, N, K;
  int x_e_max, x_n_man, w_e_max;
  float x_max_value;
  float delta;      // ADC step
  float inv_delta;  // 1 / delta when delta is a power of two, else 0
};

// Exact 2^e for e in [-126, 127].
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((e + 127) << 23);
}

// Effective exponent in [1, e_max] of a magnitude, from its f32 bits.
__device__ __forceinline__ int eff_exp(float a, int e_max) {
  const int floor_log2 = ((__float_as_int(a) >> 23) & 0xff) - 127;
  return min(max(floor_log2 + 1 + e_max, 1), e_max);
}

__device__ __forceinline__ float adc(float v, float delta, float inv_delta) {
  // v * (1 / delta) equals v / delta when delta is a power of two
  const float t = inv_delta != 0.f ? __fmul_rn(v, inv_delta)
                                   : __fdiv_rn(v, delta);
  const float q = __fmul_rn(rintf(t), delta);
  return fminf(fmaxf(q, -1.f), 1.f);
}

template <int N_R, int GRAN, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
grmac_kernel(const Params p) {
  constexpr int NTX = BN / TN;
  constexpr int NTY = BM / TM;
  constexpr int NT = NTX * NTY;
  constexpr int KC = N_R < 32 ? N_R : 32;  // K rows staged per chunk
  constexpr int CHUNKS = N_R / KC;
  constexpr int XP = BM + 1;  // odd pitch: the transposed x stores spread over banks

  __shared__ float xs[KC][XP];
  __shared__ float gxs[GRAN == kConv ? 1 : KC][XP];
  __shared__ float ws[KC][BN];
  __shared__ float gws[GRAN == kUnit ? KC : 1][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int lsb_shift = p.x_e_max + p.x_n_man + 1;

  float acc[TM][TN];
  float num[TM][TN];
  float den[TM][GRAN == kUnit ? TN : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < p.K; kb += N_R) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) num[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < (GRAN == kUnit ? TN : 1); ++j) den[i][j] = 0.f;
    }

    for (int c = 0; c < CHUNKS; ++c) {
      const int k0 = kb + c * KC;
      __syncthreads();  // the previous chunk is fully consumed
      for (int idx = tid; idx < BM * KC; idx += NT) {
        const int r = idx / KC;
        const int kk = idx % KC;
        const int row = m0 + r;
        float q = 0.f;
        int e = 1;
        if (row < p.M) {
          const float xv = p.x[(size_t)row * p.K + k0 + kk];
          const float a = fabsf(xv);
          const float lsb = pow2i(eff_exp(a, p.x_e_max) - lsb_shift);
          float qa = __fmul_rn(rintf(__fdiv_rn(a, lsb)), lsb);
          qa = fminf(qa, p.x_max_value);
          e = eff_exp(qa, p.x_e_max);
          q = xv < 0.f ? -qa : qa;
        }
        xs[kk][r] = q;
        if constexpr (GRAN != kConv) gxs[kk][r] = pow2i(e);
      }
      for (int idx = tid; idx < KC * BN; idx += NT) {
        const int kk = idx / BN;
        const int cc = idx % BN;
        const int col = n0 + cc;
        const float wv = col < p.N ? p.w[(size_t)(k0 + kk) * p.N + col] : 0.f;
        ws[kk][cc] = wv;
        if constexpr (GRAN == kUnit) gws[kk][cc] = pow2i(eff_exp(fabsf(wv), p.w_e_max));
      }
      __syncthreads();

#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * NTY];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * NTX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) num[i][j] = fmaf(a[i], b[j], num[i][j]);
        if constexpr (GRAN == kRow) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
            den[i][0] = __fadd_rn(den[i][0], gxs[kk][ty + i * NTY]);
        }
        if constexpr (GRAN == kUnit) {
          float gb[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j) gb[j] = gws[kk][tx + j * NTX];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float g = gxs[kk][ty + i * NTY];
#pragma unroll
            for (int j = 0; j < TN; ++j) den[i][j] = fmaf(g, gb[j], den[i][j]);
          }
        }
      }
    }

    // the analog column's epilogue: den -> ADC -> renormalize -> accumulate
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float z;
        if constexpr (GRAN == kConv) {
          // N_R is a power of two: the product is the exact quotient
          const float v = __fmul_rn(num[i][j], 1.f / N_R);
          z = __fmul_rn(adc(v, p.delta, p.inv_delta), (float)N_R);
        } else {
          const int e_sum = GRAN == kRow ? p.x_e_max : p.x_e_max + p.w_e_max;
          const float d = den[i][GRAN == kUnit ? j : 0];
          const float v = __fdiv_rn(__fmul_rn(num[i][j], pow2i(e_sum)), d);
          z = __fmul_rn(adc(v, p.delta, p.inv_delta),
                        __fmul_rn(d, pow2i(-e_sum)));
        }
        acc[i][j] = __fadd_rn(acc[i][j], z);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * NTY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * NTX;
      if (row < p.M && col < p.N) p.out[(size_t)row * p.N + col] = acc[i][j];
    }
  }
}

template <int N_R, int GRAN, int BM, int BN, int TM, int TN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  grmac_kernel<N_R, GRAN, BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
  return cudaGetLastError();
}

template <int N_R, int GRAN>
cudaError_t launch_tiles(const Params& p, cudaStream_t stream) {
  // 64 x 64 tiles once they make at least one wave over the 132 SMs;
  // otherwise 8 x 32 tiles, which spread decode-sized M over N.
  const long big_tiles = (long)((p.M + 63) / 64) * ((p.N + 63) / 64);
  if (big_tiles >= 132) return launch<N_R, GRAN, 64, 64, 4, 4>(p, stream);
  return launch<N_R, GRAN, 8, 32, 1, 1>(p, stream);
}

template <int N_R>
cudaError_t launch_granularity(const Params& p, int granularity,
                               cudaStream_t stream) {
  switch (granularity) {
    case kConv: return launch_tiles<N_R, kConv>(p, stream);
    case kRow: return launch_tiles<N_R, kRow>(p, stream);
    case kUnit: return launch_tiles<N_R, kUnit>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. x (M, K), w (K, N) and out (M, N) are contiguous
// float32 device arrays; K is a multiple of n_r, n_r is one of 16, 32, 64,
// 128; granularity is 0 conv, 1 row, 2 unit. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int grmac_matmul_f32(const float* x, const float* w, float* out,
                                int M, int N, int K, int n_r, int granularity,
                                int x_n_exp, int x_n_man, int w_n_exp,
                                float delta, float inv_delta, void* stream) {
  if (n_r <= 0 || M <= 0 || N <= 0 || K <= 0 || K % n_r != 0) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.x_e_max = (1 << x_n_exp) - 1;
  p.x_n_man = x_n_man;
  p.w_e_max = (1 << w_n_exp) - 1;
  p.x_max_value = 1.f - std::ldexp(1.f, -x_n_man - 1);  // exact
  p.delta = delta;
  p.inv_delta = inv_delta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_r) {
    case 16: return launch_granularity<16>(p, granularity, s);
    case 32: return launch_granularity<32>(p, granularity, s);
    case 64: return launch_granularity<64>(p, granularity, s);
    case 128: return launch_granularity<128>(p, granularity, s);
    default: return cudaErrorInvalidValue;
  }
}
