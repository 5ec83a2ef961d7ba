// GR-MAC matmul, decode design: small M (up to the switch set by
// kernels/grmac_matmul.py), weight streaming with split-K. Its values dot
// is f32 FMA, so it also takes every M for formats whose values bf16
// cannot hold (n_man > 7), which the tensor-core design would round.
//
// At M = 8 the weights are the bytes: every code is read once and used for
// only 8 multiply-adds. So the work is cut along N and along K:
//  * a warp owns 32 neighbouring columns and a range of K steps (a step is
//    max(n_r, 32) codes of one column: 16 to 128 bytes); each thread
//    streams its column's steps through a private cp.async ring in shared
//    memory, DEPTH steps in flight, so a warp's 16-byte copies of one group
//    cover 512 contiguous bytes;
//  * the 8 warps of a block are wcols column groups x 8 / wcols K splits,
//    and the blocks of a thread-block cluster (1 x splits x 1, splits <= 8)
//    split K further; the host picks the widest column tile whose grid
//    still fills the 132 SMs (24 blocks for N = 768 without the K split;
//    1000 blocks, each quantizing x again, for the LM head at 32 columns);
//  * each block copies its 8 rows of x over its K range into shared memory
//    with cp.async (all loads in flight at once), then quantizes them in
//    place (x / sx, the format grid, the gains; per (row, analog column)
//    gain sums for row granularity). x is stored
//    K-major, 8 rows per K index, so a code's 8 products take two 16-byte
//    loads that every lane of a warp shares (a broadcast); 4-bit codes are
//    decoded two at a time, a byte through a 256-entry table of value
//    pairs.
// The reduction is deterministic and has no atomics: each thread sums its
// block terms in K order, the block sums its K splits in K order through
// shared memory, and cluster rank 0 sums the blocks' partials in K order
// through distributed shared memory, then applies sx * sw and stores.
#include <cooperative_groups.h>

#include <algorithm>

#include "grmac_common.cuh"

namespace cg = cooperative_groups;

namespace grmac {
namespace {

constexpr int kRows = 8;      // rows of x per block; blockIdx.z picks them
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSpan = 2304;  // K codes of x a block stages (shared memory)

template <int N_R, int CB>
struct Shape {
  static constexpr int STEP = N_R > 32 ? N_R : 32;   // codes per step
  static constexpr int STEP_BYTES = STEP * CB / 8;   // 16 .. 128
  static constexpr int STEP_VEC = STEP_BYTES / 16;   // 16-byte groups
  static constexpr int STEP_WORDS = STEP_BYTES / 4;
  static constexpr int GROUP = 128 / CB;             // codes per group
  static constexpr int DEPTH = STEP_BYTES <= 16 ? 4 : 2;
  static constexpr int COLS = STEP / N_R;            // analog columns a step
};

template <int N_R, int GRAN, int CB>
size_t smem_bytes(int span) {
  using S = Shape<N_R, CB>;
  const size_t floats = 1024 + (size_t)kRows * span +
                        (GRAN == kUnit ? (size_t)kRows * span : 0) +
                        (GRAN == kRow ? (size_t)kRows * (span / N_R) : 0) +
                        kWarps * kRows * 32 + kRows * kThreads;
  return (size_t)S::DEPTH * kThreads * S::STEP_BYTES + 4 * floats;
}

// acc[r] += x[k][r] * w.x, then x[k + 1][r] * w.y, for the 8 rows: four
// 16-byte loads of K-major x
__device__ __forceinline__ void fma_rows(float (&acc)[kRows], const float* x,
                                         float2 w) {
  const float4* v = reinterpret_cast<const float4*>(x);
  const float4 a0 = v[0], a1 = v[1], b0 = v[2], b1 = v[3];
  const float xa[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float xb[kRows] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xa[r], w.x, acc[r]);
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xb[r], w.y, acc[r]);
}

// At least one block per SM: without the bound ptxas holds the row
// instances to 48 registers and spills around the IEEE division's slow
// path (a called subroutine); with it, 0 spills at 87-90 registers. (The
// same bound on the prefill kernel cost it 10%: PERF.md.)
template <int N_R, int GRAN, int CB>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const Params p) {
  using S = Shape<N_R, CB>;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  // code -> value (8-bit codes) or byte -> two values (4-bit codes), and
  // the same for the weight gains (unit granularity)
  float2* lut2 = reinterpret_cast<float2*>(ring + S::DEPTH * kThreads * S::STEP_VEC);
  float2* glut2 = lut2 + 256;
  float* lut = reinterpret_cast<float*>(lut2);
  float* glut = reinterpret_cast<float*>(glut2);
  float* xq = reinterpret_cast<float*>(glut2 + 256);  // [k][kRows], K-major
  float* gx = xq + kRows * p.span;
  const int den_pitch = p.span / N_R;
  float* den = gx + (GRAN == kUnit ? kRows * p.span : 0);
  float* red = den + (GRAN == kRow ? kRows * den_pitch : 0);
  float* blk = red + kWarps * kRows * 32;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wc = p.wcols;            // column groups of a block
  const int kps = kWarps / wc;       // K splits of a block
  const int cols = 32 * wc;          // columns of a block
  const int ccol = min((int)blockIdx.x * cols + (warp % wc) * 32 + lane,
                       p.N - 1);
  const int rank = blockIdx.y;  // the cluster spans the grid's y extent
  const int m0 = blockIdx.z * kRows;
  const int ts = p.k_store / S::STEP;
  const int nsplit = kps * p.splits;
  const int split = rank * kps + warp / wc;
  const int first = (int)((long)split * ts / nsplit);
  const int nsteps = (int)((long)(split + 1) * ts / nsplit) - first;
  const int block_first = (int)((long)rank * kps * ts / nsplit);
  const int kbase = block_first * S::STEP;
  const int kspan =
      ((int)((long)(rank + 1) * kps * ts / nsplit) - block_first) * S::STEP;

  // x first (one cp.async group), then the weight stream; both in flight
  // while the tables are staged
  for (int idx = tid; idx < kRows * kspan; idx += kThreads) {
    const int r = idx / kspan;
    const int kk = idx - r * kspan;
    const int row = m0 + r;
    const int k = kbase + kk;
    if (row < p.M && k < p.K)
      cp_async4(xq + kk * kRows + r, p.x + (size_t)row * p.K + k);
    else
      xq[kk * kRows + r] = 0.f;
  }
  cp_async_commit();
  auto fetch = [&](int i) {
    uint4* dst = ring + ((i % S::DEPTH) * kThreads + tid) * S::STEP_VEC;
    const size_t g0 = (size_t)(first + i) * S::STEP_VEC;
#pragma unroll
    for (int v = 0; v < S::STEP_VEC; ++v)
      cp_async16(dst + v, p.codes + ((g0 + v) * p.N + ccol) * 16);
  };
#pragma unroll
  for (int i = 0; i < S::DEPTH; ++i) {
    if (i < nsteps) fetch(i);
    cp_async_commit();
  }

  auto value = [&](int c) { return c < p.n_codes ? __ldg(p.lut + c) : 0.f; };
  auto gain = [&](int c) { return pow2i(eff_exp(fabsf(value(c)), p.w_e_max)); };
  for (int c = tid; c < 256; c += kThreads) {
    if constexpr (CB == 4) {
      lut2[c] = make_float2(value(c & 15), value(c >> 4));
      if constexpr (GRAN == kUnit) glut2[c] = make_float2(gain(c & 15), gain(c >> 4));
    } else {
      lut[c] = value(c);
      if constexpr (GRAN == kUnit) glut[c] = gain(c);
    }
  }
  const float sx = prescale(p);
  cp_async_wait<S::DEPTH>();  // this thread's copies of x have landed
  __syncthreads();
  for (int idx = tid; idx < kRows * kspan; idx += kThreads) {
    int e;
    xq[idx] = quantize_x(xq[idx], sx, p, &e);
    if constexpr (GRAN == kUnit) gx[idx] = pow2i(e);
  }
  __syncthreads();
  if constexpr (GRAN == kRow) {
    const int jn = kspan / N_R;
    for (int idx = tid; idx < kRows * jn; idx += kThreads) {
      const int r = idx / jn;
      const int jj = idx - r * jn;
      const float* xr = xq + jj * N_R * kRows + r;
      float d = 0.f;
      for (int kk = 0; kk < N_R; ++kk)
        d = __fadd_rn(d, pow2i(eff_exp(fabsf(xr[kk * kRows]), p.x_e_max)));
      den[r * den_pitch + jj] = d;
    }
    __syncthreads();
  }

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<S::DEPTH - 1>();  // this thread's step i has landed
    uint32_t w[S::STEP_WORDS];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(
        ring + ((i % S::DEPTH) * kThreads + tid) * S::STEP_VEC);
#pragma unroll
    for (int q = 0; q < S::STEP_WORDS; ++q) w[q] = src[q];
    if (i + S::DEPTH < nsteps) fetch(i + S::DEPTH);
    cp_async_commit();
    const int kloc = (first + i) * S::STEP - kbase;
#pragma unroll
    for (int sub = 0; sub < S::COLS; ++sub) {
      float num[kRows], dd[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) num[r] = dd[r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N_R; kk += 2) {  // codes k and k + 1
        const int k = sub * N_R + kk;
        float2 wv, gw;
        if constexpr (CB == 4) {
          const int b = (w[k / 8] >> (4 * (k % 8))) & 255;
          wv = lut2[b];
          if constexpr (GRAN == kUnit) gw = glut2[b];
        } else {
          const int c0 = (w[k / 4] >> (8 * (k % 4))) & 255;
          const int c1 = (w[(k + 1) / 4] >> (8 * ((k + 1) % 4))) & 255;
          wv = make_float2(lut[c0], lut[c1]);
          if constexpr (GRAN == kUnit) gw = make_float2(glut[c0], glut[c1]);
        }
        fma_rows(num, xq + (kloc + k) * kRows, wv);
        if constexpr (GRAN == kUnit) fma_rows(dd, gx + (kloc + k) * kRows, gw);
      }
      if ((first + i) * S::COLS + sub < p.J) {
        const int jj = (kloc + sub * N_R) / N_R;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d = GRAN == kRow ? den[r * den_pitch + jj] : dd[r];
          acc[r] = __fadd_rn(acc[r], block_term<GRAN, N_R>(num[r], d, p));
        }
      }
    }
  }

  // a block's K splits in K order, then the cluster's blocks in K order;
  // warp w is column group w % wc, K split w / wc
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[(warp * kRows + r) * 32 + lane] = acc[r];
  __syncthreads();
  for (int o = tid; o < kRows * cols; o += kThreads) {
    const int r = o / cols;
    const int c = o - r * cols;
    float s = red[((c / 32) * kRows + r) * 32 + c % 32];
    for (int ks = 1; ks < kps; ++ks)
      s = __fadd_rn(s, red[((ks * wc + c / 32) * kRows + r) * 32 + c % 32]);
    blk[o] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const float scale = postscale(p);
    for (int o = tid; o < kRows * cols; o += kThreads) {
      float s = blk[o];
      for (int q = 1; q < p.splits; ++q)
        s = __fadd_rn(s, cluster.map_shared_rank(blk, q)[o]);
      const int row = m0 + o / cols;
      const int col = blockIdx.x * cols + o % cols;
      if (row < p.M && col < p.N)
        p.out[(size_t)row * p.N + col] = __fmul_rn(s, scale);
    }
  }
  cluster.sync();  // the other blocks' shared memory outlives rank 0's reads
}

template <int N_R, int GRAN, int CB>
cudaError_t launch_t(Params p, cudaStream_t stream) {
  using S = Shape<N_R, CB>;
  const int ts = p.k_store / S::STEP;
  const int mchunks = (p.M + kRows - 1) / kRows;
  auto span_of = [&](int sp) { return ((ts + sp - 1) / sp) * S::STEP; };
  // the widest column tile (fewest copies of x to quantize) whose grid
  // makes a wave over the 132 SMs; else the one with the most blocks
  long best_blocks = 0;
  for (int wc = 8; wc >= 1; wc /= 2) {
    const int kps = kWarps / wc;
    const long tiles = (long)((p.N + 32 * wc - 1) / (32 * wc)) * mchunks;
    // two blocks per SM where the K steps allow, at most 8 (a portable
    // cluster), each warp at least one step
    int sp = (int)std::min(8L, std::max(1L, (2 * 132 + tiles - 1) / tiles));
    while (sp > 1 && kps * sp > ts) --sp;
    while (span_of(sp) > kMaxSpan && sp < 8) ++sp;
    if (span_of(sp) > kMaxSpan) continue;
    if (tiles * sp > best_blocks) {
      best_blocks = tiles * sp;
      p.wcols = wc;
      p.splits = sp;
      p.span = span_of(sp);
    }
    if (tiles * sp >= 132) break;
  }
  if (best_blocks == 0) return cudaErrorInvalidValue;
  const int splits = p.splits;

  auto kern = decode_kernel<N_R, GRAN, CB>;
  const size_t smem = smem_bytes<N_R, GRAN, CB>(p.span);
  static size_t smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + 32 * p.wcols - 1) / (32 * p.wcols), splits,
                     mchunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

template <int N_R, int GRAN>
cudaError_t launch_bits(const Params& p, cudaStream_t stream) {
  return p.code_bits == 4 ? launch_t<N_R, GRAN, 4>(p, stream)
                          : launch_t<N_R, GRAN, 8>(p, stream);
}

template <int N_R>
cudaError_t launch_gran(const Params& p, int granularity, cudaStream_t stream) {
  switch (granularity) {
    case kConv: return launch_bits<N_R, kConv>(p, stream);
    case kRow: return launch_bits<N_R, kRow>(p, stream);
    case kUnit: return launch_bits<N_R, kUnit>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_decode(const Params& p, int n_r, int granularity,
                          cudaStream_t stream) {
  switch (n_r) {
    case 16: return launch_gran<16>(p, granularity, stream);
    case 32: return launch_gran<32>(p, granularity, stream);
    case 64: return launch_gran<64>(p, granularity, stream);
    case 128: return launch_gran<128>(p, granularity, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace grmac
