// GR-MAC matmul for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces src/repro/kernels/grmac_matmul.py::grmac_matmul_pallas, the
// Pallas TPU kernel (body _kernel, helpers _pow2, _quant_decompose, _adc),
// together with the pre- and post-scale that src/repro/kernels/ops.py runs
// around it. Its plain PyTorch version is src/repro_torch/kernels/ref.py
// after the scaling in kernels/ops.py; the wrapper that builds, binds and
// launches these sources is kernels/grmac_matmul.py.
//
// What it computes: out = (M, K) @ (K, N) through the analog CIM signal
// chain. x arrives raw and is divided here by sx = max(amax|x|, 1e-12)
// and quantized onto fmt_x; w arrives once-prepared as fmt_w codes
// (kernels/packed.py) with its scale sw. For each n_r-deep K sub-block
// (one analog column): num = xq_blk . w_blk, then by granularity
//   row:  den = sum of 2^E(xq) over the block, per row;
//         v = num * 2^e_max_x / den;  z = ADC(v) * den * 2^-e_max_x
//   unit: den = 2^E(xq) . 2^E(w) per (row, col);
//         v = num * 2^(e_max_x + e_max_w) / den;  z = ADC(v) * den / 2^(..)
//   conv: v = num / n_r;  z = ADC(v) * n_r
// with the mid-tread ADC clip(rint(v / delta) * delta, -1, 1); the block
// terms z are summed in K order and the sum is multiplied by sx * sw.
//
// What bounds it on this card (H100 SXM data sheet: 3.35 TB/s HBM, 67
// TFLOP/s f32 outside the tensor cores, 989 TFLOP/s bf16 tensor cores):
// decode at M = 8 is bound by the weight bytes, 69 MB of 4-bit codes per
// forward of paper-cim-120m (21 us at 3.35 TB/s; 551 MB as f32), and in
// practice by launch latency. At prefill shapes every (row, block, col)
// needs an epilogue of about ten f32 operations, an IEEE division among
// them, beside 2 * n_r multiply-adds of the values dot, which the tensor
// cores take.
//
// Two designs, chosen per call by the wrapper (a route by shape and
// format; neither is a fallback of the other):
//   grmac_decode.cuh  small M, and any M for formats bf16 cannot hold: an
//                     f32-FMA body, weight streaming, split-K over the
//                     analog columns across a thread-block cluster,
//                     deterministic reduction through distributed shared
//                     memory;
//   grmac_prefill.cuh larger M, formats exact in bf16: the values dot (and
//                     unit granularity's gain product) on the tensor cores
//                     with mma.sync, cp.async double buffering, split-K
//                     across a cluster where the tiles under-fill the card.
// Each design compiles in two sources, its plain instantiation
// (grmac_{decode,prefill}.cu) and its sanitizing one (*_san.cu); each
// source is compiled by its own nvcc process and the objects are linked
// into one library with this C interface.
//
// For FP6_E3M2 x FP4_E2M1 every product is a multiple of 2^-13 and every
// n_r-deep sum fits in 18 bits, and every block term is a multiple of
// 2^-13 below 2^11, so num, den and the output are exact in any order and
// each design equals the plain version bit for bit. Wider formats lose
// that exactness; there each design's fixed order keeps the result the
// same from run to run, within 1e-5 of the plain version.
#include <cmath>

#include "grmac_common.cuh"

// C interface for ctypes. x (M, K) and out (M, N) are contiguous float32
// device arrays; codes are kernels/packed.py's layout, k_store a multiple
// of max(n_r, 32), lut its code -> value table of 2^w_bits floats; amax and
// sw are float32 device scalars. n_r is one of 16, 32, 64, 128;
// granularity is 0 conv, 1 row, 2 unit; design 0 decode, 1 prefill.
// san is null (the plain instantiation) or a zeroed 5-entry uint64 device
// buffer that the sanitizing instantiation adds its counts to
// (grmac_common.cuh). Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
extern "C" int grmac_matmul_packed(
    const float* x, const void* codes, const float* lut, const float* amax,
    const float* sw, float* out, int M, int N, int K, int k_store, int n_r,
    int code_bits, int granularity, int design, int x_n_exp, int x_n_man,
    int w_n_exp, int w_n_man, float delta, float inv_delta, void* san,
    void* stream) {
  using namespace grmac;
  const int step = n_r > 32 ? n_r : 32;
  if (n_r <= 0 || M <= 0 || N <= 0 || K <= 0 || k_store < K ||
      k_store % step != 0 || (code_bits != 4 && code_bits != 8)) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.codes = static_cast<const uint8_t*>(codes);
  p.lut = lut;
  p.amax = amax;
  p.sw = sw;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.J = (K + n_r - 1) / n_r;
  p.k_store = k_store;
  p.code_bits = code_bits;
  p.n_codes = 1 << (1 + w_n_exp + w_n_man);
  p.x_e_max = (1 << x_n_exp) - 1;
  p.x_n_man = x_n_man;
  p.w_e_max = (1 << w_n_exp) - 1;
  p.x_max_value = 1.f - std::ldexp(1.f, -x_n_man - 1);  // exact
  p.delta = delta;
  p.inv_delta = inv_delta;
  p.splits = 1;
  p.wcols = 1;
  p.span = 0;
  p.san = static_cast<unsigned long long*>(san);
  if (p.n_codes > 256) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case kDecode:
      return p.san ? launch_decode_san(p, n_r, granularity, s)
                   : launch_decode(p, n_r, granularity, s);
    case kPrefill:
      return p.san ? launch_prefill_san(p, n_r, granularity, s)
                   : launch_prefill(p, n_r, granularity, s);
    default: return cudaErrorInvalidValue;
  }
}
