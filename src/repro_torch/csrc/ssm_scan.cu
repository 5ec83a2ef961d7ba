// Mamba2 SSD recurrence over a whole dispatch for NVIDIA Hopper (sm_90a),
// written by hand.
//
// Replaces no TPU kernel: the JAX package runs the serving recurrence as a
// lax.scan of plain jnp steps (src/repro/models/ssm.py, ssm_prefill). Its
// plain version is the per-step loop of src/repro_torch/models/ssm.py
// (_recurrence_step under _loop), which the port keeps for CPU and meta
// tensors and which the card tests hold this kernel to. The wrapper is
// kernels/ssm_scan.py; this source is compiled into the port's kernel
// library beside the GR-MAC sources, by its own nvcc process.
//
// What it computes, per lane b and head h, for t = 0 .. S-1, from the
// state H (N x P, f32) and the conv window (W - 1 steps of the head's P
// channels, f32):
//   conv:  c = win[0]*k[0] + win[1]*k[1] + ... + x_t*k[W-1]   (tap order)
//   silu:  xs = c * (1 / (1 + exp(-c)))
//   decay: a = exp(-dt_t * rate_h)
//   state: Hn[n,p] = a * H[n,p] + (dt_t * B_t[n]) * xs[p]
//   out:   y_t[p] = sum_n C_t[n] * Hn[n,p] + D_h * xs[p]
// and commits Hn and the shifted window (win[1..], x_t) only at steps
// t < length[b]: a padded step still writes its y, computed from the
// frozen state, and a lane of length 0 gets its state back bit for bit.
//
// What bounds it on this card: bytes and latency. The state is N*P f32 a
// (lane, head), 16.8 MB a layer at mamba2-1.3b's 8 lanes x 64 heads of
// 128 x 64: read once and written once, about 10 us at 3.35 TB/s. The
// per-step inputs (x, B, C, dt) are a few KB. The per-step loop this
// replaces issued ~21 launches a step and layer and re-read the state 4-5
// times a step.
//
// Design: one block of threads per (lane, head) holds that head's H in
// registers across all S steps. The steps go in tiles of TS: the block
// stages the tile's x, B, C and dt in shared memory with one round of
// loads; one thread a channel runs the conv and silu over the tile's steps,
// its window and taps in registers, into shared memory; then every thread
// runs the tile's recurrence steps from shared memory, with no load from
// device memory between two steps.
//
// Exactness: each product and sum of the state, the window, the decay and
// the skip term is rounded on its own (__fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA), in the order of the plain
// version's separate ATen kernels; exp is expf (not __expf) and silu
// divides as PyTorch's CUDA sigmoid does, 1 / (1 + exp(-c)). So the state
// and the window equal the plain version's bit for bit. y's sum over n
// takes the order of the plain version's einsum, which cuBLAS runs as a
// gemv (its gemvx kernel, CUDA 12.8, H100) that at 8 lanes splits n into
// NG contiguous blocks (8 of 16 at N 128, 4 of 4 at N 16), sums each in
// order from its first product by FMA, and adds the blocks' sums as a tree
// (block i with block i + NG/2, halving): each thread holds one block of n
// for PT channels, and lanes g = 0 .. NG-1 of a channel add their sums by
// warp shuffles at offsets NG/2, ..., 1, which is that tree. So at the
// engine's 8 lanes y equals the plain version's bit for bit too (measured
// on the card); at other lane counts cuBLAS splits otherwise, and y agrees
// within the reordering of an N-term f32 sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ssm {
namespace {

struct Params {
  const void* x;        // (B, S, NH * P) rows at x_sb / x_ss, f32 or bf16
  const float* bmat;    // (B, S, N) rows at b_sb / b_ss
  const float* cmat;    // (B, S, N) rows at c_sb / c_ss
  const float* dt;      // (B, S, NH) rows at dt_sb / dt_ss
  const float* rate;    // (NH,) exp(A_log)
  const float* d_skip;  // (NH,)
  const float* taps;    // (W, NH * P), contiguous
  const float* h_in;    // (B, NH, N, P), contiguous
  const float* win_in;  // (B, W - 1, NH * P), contiguous
  const void* length;   // (B,) int32 or int64, or null: every step commits
  float* y;             // (B, S, NH * P), contiguous
  float* h_out;         // as h_in
  float* win_out;       // as win_in
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dt_sb, dt_ss;
  int S, NH, length_bytes;
};

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 1 / (1 + exp(-c)), each step rounded as PyTorch's CUDA sigmoid does
__device__ __forceinline__ float sigmoid(float c) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-c)));
}

template <int N, int P, int NG, int PT>
struct Layout {
  static constexpr int NPG = N / NG;        // rows of n a thread holds
  static constexpr int PL = 32 / NG;        // lanes along p
  static constexpr int THREADS = P / (PL * PT) * 32;
  static_assert(N % NG == 0 && 32 % NG == 0 && P % (PL * PT) == 0 &&
                    P <= THREADS,
                "a layout of whole warps and a thread a channel");
};

template <int N, int P, int W, int NG, int PT, int TS, typename XT>
__global__ void __launch_bounds__(Layout<N, P, NG, PT>::THREADS, 4)
scan_kernel(const Params p) {
  using L = Layout<N, P, NG, PT>;
  constexpr int NPG = L::NPG, PL = L::PL, THREADS = L::THREADS;
  // B and C padded by one a block of n: the NG blocks' rows read by one
  // instruction fall in distinct banks
  constexpr int NS = N + NG;
  __shared__ float s_b[TS][NS], s_c[TS][NS], s_x[TS][P], s_xs[TS][P],
      s_dt[TS];
  const int b = blockIdx.x / p.NH, h = blockIdx.x % p.NH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % NG;                        // block of n
  const int p0 = (warp * PL + lane / NG) * PT;     // first channel
  const int n0 = g * NPG, s0 = g * (NPG + 1);     // its rows; in s_b, s_c
  const int chans = p.NH * P;

  const long long h_off = (static_cast<long long>(blockIdx.x) * N) * P;
  float hs[NPG][PT];
#pragma unroll
  for (int j = 0; j < NPG; ++j)
#pragma unroll
    for (int q = 0; q < PT; ++q)
      hs[j][q] = p.h_in[h_off + (n0 + j) * P + p0 + q];
  // the conv's thread of channel tid: its window and taps
  const bool conv = tid < P;
  const long long w_off =
      static_cast<long long>(b) * (W - 1) * chans + h * P + tid;
  float win[W - 1], taps[W];
  if (conv) {
#pragma unroll
    for (int j = 0; j < W - 1; ++j) win[j] = p.win_in[w_off + j * chans];
#pragma unroll
    for (int j = 0; j < W; ++j) taps[j] = p.taps[j * chans + h * P + tid];
  }
  const float rate = p.rate[h], dsk = p.d_skip[h];
  long long len = p.S;
  if (p.length != nullptr) {
    len = p.length_bytes == 8 ? static_cast<const long long*>(p.length)[b]
                              : static_cast<const int*>(p.length)[b];
  }
  const XT* xb = static_cast<const XT*>(p.x) + b * p.x_sb + h * P;
  const float* bb = p.bmat + b * p.b_sb;
  const float* cb = p.cmat + b * p.c_sb;
  const float* db = p.dt + b * p.dt_sb + h;
  float* yb = p.y + static_cast<long long>(b) * p.S * chans + h * P + p0;

  for (int t0 = 0; t0 < p.S; t0 += TS) {
    const int ts = min(TS, p.S - t0);
    __syncthreads();  // the last tile's shared memory is read
    for (int i = tid; i < ts * N; i += THREADS) {
      const int t = i / N, n = i % N, sn = n + n / NPG;
      s_b[t][sn] = bb[(t0 + t) * p.b_ss + n];
      s_c[t][sn] = cb[(t0 + t) * p.c_ss + n];
    }
    for (int i = tid; i < ts * P; i += THREADS) {
      const int t = i / P, c = i % P;
      s_x[t][c] = as_f32(xb[(t0 + t) * p.x_ss + c]);
    }
    if (tid < ts) s_dt[tid] = db[(t0 + tid) * p.dt_ss];
    __syncthreads();
    if (conv) {
      for (int t = 0; t < ts; ++t) {
        const float xin = s_x[t][tid];
        float c = __fmul_rn(win[0], taps[0]);
#pragma unroll
        for (int j = 1; j < W - 1; ++j)
          c = __fadd_rn(c, __fmul_rn(win[j], taps[j]));
        c = __fadd_rn(c, __fmul_rn(xin, taps[W - 1]));
        s_xs[t][tid] = __fmul_rn(c, sigmoid(c));
        if (t0 + t < len) {
#pragma unroll
          for (int j = 0; j < W - 2; ++j) win[j] = win[j + 1];
          win[W - 2] = xin;
        }
      }
    }
    __syncthreads();
    for (int t = 0; t < ts; ++t) {
      const bool commit = t0 + t < len;
      const float dt = s_dt[t];
      const float a = expf(__fmul_rn(-dt, rate));
      float xs[PT], acc[PT];
#pragma unroll
      for (int q = 0; q < PT; ++q) xs[q] = s_xs[t][p0 + q];
#pragma unroll
      for (int j = 0; j < NPG; ++j) {
        const float dtb = __fmul_rn(dt, s_b[t][s0 + j]);
        const float cn = s_c[t][s0 + j];
#pragma unroll
        for (int q = 0; q < PT; ++q) {
          const float hn =
              __fadd_rn(__fmul_rn(a, hs[j][q]), __fmul_rn(dtb, xs[q]));
          acc[q] = j == 0 ? __fmul_rn(cn, hn) : __fmaf_rn(cn, hn, acc[q]);
          if (commit) hs[j][q] = hn;
        }
      }
#pragma unroll
      for (int q = 0; q < PT; ++q) {
#pragma unroll
        for (int off = NG / 2; off > 0; off >>= 1)
          acc[q] =
              __fadd_rn(acc[q], __shfl_xor_sync(0xffffffffu, acc[q], off));
        if (g == 0)
          yb[static_cast<long long>(t0 + t) * chans + q] =
              __fadd_rn(acc[q], __fmul_rn(dsk, xs[q]));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NPG; ++j)
#pragma unroll
    for (int q = 0; q < PT; ++q)
      p.h_out[h_off + (n0 + j) * P + p0 + q] = hs[j][q];
  if (conv) {
#pragma unroll
    for (int j = 0; j < W - 1; ++j) p.win_out[w_off + j * chans] = win[j];
  }
}

// steps a tile stages in shared memory: a 16-token chunk in one
constexpr int kTileSteps = 16;

template <int N, int P, int W, int NG, int PT>
cudaError_t launch(const Params& p, int batch, bool x_bf16,
                   cudaStream_t stream) {
  constexpr int threads = Layout<N, P, NG, PT>::THREADS;
  const dim3 grid(batch * p.NH);
  if (x_bf16) {
    scan_kernel<N, P, W, NG, PT, kTileSteps, __nv_bfloat16>
        <<<grid, threads, 0, stream>>>(p);
  } else {
    scan_kernel<N, P, W, NG, PT, kTileSteps, float>
        <<<grid, threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssm

// C interface for ctypes. x is f32 (x_bf16 = 0) or bf16 (1), bmat, cmat and
// dt are f32, each (B, S, ...) with the given batch and step strides in
// elements and unit stride along its last dimension; rate and d_skip (NH,),
// taps (W, NH * P), h_in / h_out (B, NH, N, P) and win_in / win_out (B,
// W - 1, NH * P) are contiguous f32, y (B, S, NH * P) contiguous f32.
// length is null (every step commits) or (B,) of length_bytes 4 or 8.
// (N, P, W) is one of (128, 64, 4) and (16, 32, 4). Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
extern "C" int ssm_scan(
    const void* x, int x_bf16, long long x_sb, long long x_ss,
    const float* bmat, long long b_sb, long long b_ss, const float* cmat,
    long long c_sb, long long c_ss, const float* dt, long long dt_sb,
    long long dt_ss, const float* rate, const float* d_skip,
    const float* taps, const float* h_in, const float* win_in,
    const void* length, int length_bytes, float* y, float* h_out,
    float* win_out, int B, int S, int NH, int N, int P, int W,
    void* stream) {
  if (B <= 0 || S <= 0 || NH <= 0 ||
      (length != nullptr && length_bytes != 4 && length_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  ssm::Params p{x,      bmat,  cmat, dt,    rate,  d_skip, taps,
                h_in,   win_in, length, y,  h_out, win_out, x_sb,
                x_ss,   b_sb,  b_ss, c_sb,  c_ss,  dt_sb,  dt_ss,
                S,      NH,    length_bytes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 128 && P == 64 && W == 4) {
    return ssm::launch<128, 64, 4, 8, 2>(p, B, x_bf16 != 0, s);
  }
  if (N == 16 && P == 32 && W == 4) {
    return ssm::launch<16, 32, 4, 4, 2>(p, B, x_bf16 != 0, s);
  }
  return cudaErrorInvalidValue;
}
