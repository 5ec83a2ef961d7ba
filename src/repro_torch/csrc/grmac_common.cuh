// Shared pieces of the GR-MAC kernel's two designs (grmac_decode.cu,
// grmac_prefill.cu); the entry point that picks one is grmac_matmul.cu,
// whose header says what the kernel computes.
//
// Numerics that make every design match the plain version
// (src/repro_torch/kernels/ref.py after kernels/ops.py's pre-scale):
//  * x / sx is __fdiv_rn, the same rounding as torch's x32 / sx; the output
//    is acc * (sx * sw) with both products rounded to nearest;
//  * 2^e is assembled from IEEE bits, never exp2f/ldexpf;
//  * the exponent comes from the f32 bits, clipped to [1, e_max], so zero
//    and f32 subnormals land in bin 1 (gain 2), and the gain is taken from
//    the quantized value (rounding can promote into the next binade);
//  * rounding is rintf (half to even), division is __fdiv_rn (IEEE) or a
//    product with an exact power of two, and the epilogue's products and
//    sums are __fmul_rn/__fadd_rn so no FMA contraction changes a rounding.
//    Build without -use_fast_math.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace grmac {

enum Granularity { kConv = 0, kRow = 1, kUnit = 2 };
enum Design { kDecode = 0, kPrefill = 1 };

struct Params {
  const float* x;         // (M, K) f32 activations, not yet pre-scaled
  const uint8_t* codes;   // (k_store / group, N, 16) packed fmt_w codes
  const float* lut;       // (n_codes,) code -> value on the fmt_w grid
  const float* amax;      // max |x| (device scalar); sx = max(amax, 1e-12)
  const float* sw;        // the weight's pre-scale (device scalar)
  float* out;             // (M, N) f32
  int M, N, K;
  int J;                  // analog columns: ceil(K / n_r)
  int k_store;            // K of the codes: a multiple of max(n_r, 32)
  int code_bits;          // 4 (two codes a byte) or 8
  int n_codes;            // 2^bits of fmt_w
  int x_e_max, x_n_man, w_e_max;
  float x_max_value;
  float delta;            // ADC step
  float inv_delta;        // 1 / delta when delta is a power of two, else 0
  int splits;             // decode design: blocks of a cluster along K
  int wcols;              // decode design: warps of a block along N
  int span;               // decode design: K codes staged per block
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

__device__ __forceinline__ float prescale(const Params& p) {
  return fmaxf(__ldg(p.amax), 1e-12f);
}

// The output scale sx * sw, rounded as torch rounds it.
__device__ __forceinline__ float postscale(const Params& p) {
  return __fmul_rn(prescale(p), __ldg(p.sw));
}

// x / sx quantized onto fmt_x (round half to even, saturating); *e gets
// the quantized value's effective exponent.
__device__ __forceinline__ float quantize_x(float xv, float sx,
                                            const Params& p, int* e) {
  const float xs = __fdiv_rn(xv, sx);
  const float a = fabsf(xs);
  const int lsb = eff_exp(a, p.x_e_max) - (p.x_e_max + p.x_n_man + 1);
  // a / 2^lsb as a product with the exact power of two 2^-lsb
  float qa = __fmul_rn(rintf(__fmul_rn(a, pow2i(-lsb))), pow2i(lsb));
  qa = fminf(qa, p.x_max_value);
  *e = eff_exp(qa, p.x_e_max);
  return xs < 0.f ? -qa : qa;
}

// One analog column's epilogue: den -> ADC -> renormalize; the term that
// is accumulated in K order.
template <int GRAN, int N_R>
__device__ __forceinline__ float block_term(float num, float den,
                                            const Params& p) {
  if constexpr (GRAN == kConv) {
    // N_R is a power of two: the product is the exact quotient
    const float v = __fmul_rn(num, 1.f / N_R);
    return __fmul_rn(adc(v, p.delta, p.inv_delta), (float)N_R);
  } else {
    const int e_sum = GRAN == kRow ? p.x_e_max : p.x_e_max + p.w_e_max;
    const float q = adc(__fdiv_rn(__fmul_rn(num, pow2i(e_sum)), den),
                        p.delta, p.inv_delta);
    return __fmul_rn(q, __fmul_rn(den, pow2i(-e_sum)));
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Launchers, one per design (each in its own source, built in parallel).
cudaError_t launch_decode(const Params& p, int n_r, int granularity,
                          cudaStream_t stream);
cudaError_t launch_prefill(const Params& p, int n_r, int granularity,
                           cudaStream_t stream);

}  // namespace grmac
