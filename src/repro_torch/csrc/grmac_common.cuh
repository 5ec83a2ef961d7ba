// Shared pieces of the GR-MAC kernel's two designs (grmac_decode.cuh,
// grmac_prefill.cuh); the entry point that picks one is grmac_matmul.cu,
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
//    sums are __fmul_rn/__fadd_rn so no FMA contraction changes a rounding;
//  * a NaN propagates as in torch: a NaN absmax makes sx NaN (torch.clamp
//    keeps it), and a NaN x or v stays NaN through the quantizer's
//    saturation and the ADC's clip (min/max.NaN, which cost what
//    fminf/fmaxf cost; those would drop it), with the gain exponent of
//    its bits (e_max).
//    Build without -use_fast_math.
//
// The sanitizing instantiation (template flag SAN, Params::san set; the
// checks of src/repro_torch/analysis/sanitize.py) counts, per call, the
// nonfinite and the overflowing (|v| > 1 + 1e-5) pre-ADC voltages with the
// largest finite |v|, and the gain-range violations (exponent span above
// GAIN_RANGE_LIMIT_BITS) with the largest span, each item of the grid
// once: only real rows and columns, and a (row, analog column)'s span of
// row granularity only in the blocks of the first column tile. Each thread
// sums its own, a warp reduces, lane 0 adds with atomics into the 5-entry
// buffer: nonfinite, overflow, worst |v| as float bits (atomicMax: |v| is
// never negative), gain count, worst span.
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
  unsigned long long* san;  // the sanitizer's buffer, or null
};

// GAIN_RANGE_LIMIT_BITS of src/repro_torch/core/dse.py; OVERFLOW_TOL of
// analysis/sanitize.py as float32 (the value torch compares with)
constexpr int kGainRangeLimit = 6;
constexpr float kOverflowTol = 1.00001f;

// One thread's sanitizer counts.
struct SanAcc {
  unsigned nonfinite = 0, overflow = 0, gain = 0;
  float worst_v = 0.f;
  int worst_span = 0;
};

__device__ __forceinline__ void san_value(SanAcc& s, float v, bool valid) {
  if (!valid) return;
  const float a = fabsf(v);
  if (!(a <= 3.402823466e38f)) {  // NaN or Inf
    ++s.nonfinite;
  } else {
    s.worst_v = fmaxf(s.worst_v, a);
    if (a > kOverflowTol) ++s.overflow;
  }
}

__device__ __forceinline__ void san_span(SanAcc& s, int span, bool valid) {
  if (!valid) return;
  s.worst_span = max(s.worst_span, span);
  if (span > kGainRangeLimit) ++s.gain;
}

// Adds a block's counts into the buffer; every thread of the block calls
// it (full warps).
__device__ __forceinline__ void san_flush(const SanAcc& s,
                                          unsigned long long* buf) {
  const unsigned full = 0xffffffffu;
  const unsigned nf = __reduce_add_sync(full, s.nonfinite);
  const unsigned ov = __reduce_add_sync(full, s.overflow);
  const unsigned gn = __reduce_add_sync(full, s.gain);
  const unsigned wv = __reduce_max_sync(full, __float_as_uint(s.worst_v));
  const unsigned ws = __reduce_max_sync(full, (unsigned)s.worst_span);
  if ((threadIdx.x & 31) == 0) {
    if (nf) atomicAdd(buf + 0, (unsigned long long)nf);
    if (ov) atomicAdd(buf + 1, (unsigned long long)ov);
    atomicMax(buf + 2, (unsigned long long)wv);
    if (gn) atomicAdd(buf + 3, (unsigned long long)gn);
    atomicMax(buf + 4, (unsigned long long)ws);
  }
}

// The exponent of a power of two held in f32.
__device__ __forceinline__ int exp_of(float pow2) {
  return ((__float_as_int(pow2) >> 23) & 0xff) - 127;
}

// min / max that return NaN when an operand is NaN (PTX .NaN, sm_80+).
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

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
  return fmin_nan(fmax_nan(q, -1.f), 1.f);
}

__device__ __forceinline__ float prescale(const Params& p) {
  return fmax_nan(__ldg(p.amax), 1e-12f);
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
  qa = fmin_nan(qa, p.x_max_value);
  *e = eff_exp(qa, p.x_e_max);
  return xs < 0.f ? -qa : qa;
}

// One analog column's epilogue: den -> ADC -> renormalize; the term that
// is accumulated in K order. With SAN the pre-ADC voltage v is checked
// (where ``valid``: a real row and column).
template <int GRAN, int N_R, bool SAN = false>
__device__ __forceinline__ float block_term(float num, float den,
                                            const Params& p,
                                            SanAcc* san = nullptr,
                                            bool valid = false) {
  if constexpr (GRAN == kConv) {
    // N_R is a power of two: the product is the exact quotient
    const float v = __fmul_rn(num, 1.f / N_R);
    if constexpr (SAN) san_value(*san, v, valid);
    return __fmul_rn(adc(v, p.delta, p.inv_delta), (float)N_R);
  } else {
    const int e_sum = GRAN == kRow ? p.x_e_max : p.x_e_max + p.w_e_max;
    const float v = __fdiv_rn(__fmul_rn(num, pow2i(e_sum)), den);
    if constexpr (SAN) san_value(*san, v, valid);
    const float q = adc(v, p.delta, p.inv_delta);
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

// Launchers, one per design and instantiation (each in its own source,
// built in parallel): plain, and sanitizing (_san, Params::san set).
cudaError_t launch_decode(const Params& p, int n_r, int granularity,
                          cudaStream_t stream);
cudaError_t launch_decode_san(const Params& p, int n_r, int granularity,
                              cudaStream_t stream);
cudaError_t launch_prefill(const Params& p, int n_r, int granularity,
                           cudaStream_t stream);
cudaError_t launch_prefill_san(const Params& p, int n_r, int granularity,
                               cudaStream_t stream);

}  // namespace grmac
