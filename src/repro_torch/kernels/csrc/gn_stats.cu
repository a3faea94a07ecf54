// GroupNorm statistics: per-(n, group) mean and 1/sqrt(var + eps) of an
// NHWC fp32 tensor over (H, W, C/G).
//
// Replaces the statistics pass that the TPU kernels share:
// src/repro/kernels/gn_silu.py::_stats_kernel, as called by
// gn_silu_conv.py::gn_silu_conv3x3 and output_epilogue.py::output_epilogue.
// The TPU form sums x and x^2 and takes E[x^2] - E[x]^2; at 512x512x128
// that is ~1 M elements per group and loses digits to cancellation.  Here
// each thread runs Welford's update and partial results are combined with
// Chan's formula, which keeps the variance accurate.
//
// Bound on the H100: bytes (one read of the activation; a few flops per
// element).  Design: pass 1 splits each (n, group) over S pixel slices, one
// block per (slice, group, image), so the card has thousands of blocks to
// stream with; each block reduces in a fixed tree (warp shuffles, then warp
// 0..7 in order) into partials[n][g][s].  Pass 2 merges the S partials of
// each (n, g) in slice order.  No atomics: the result is the same from run
// to run and does not depend on the batch size (every image is reduced on
// its own).

#include <cuda_runtime.h>

namespace {

struct Welford {
  float n, mean, m2;
};

__device__ __forceinline__ Welford merge(Welford a, Welford b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  Welford r;
  r.n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float fb = b.n / r.n;
  r.mean = a.mean + d * fb;
  r.m2 = a.m2 + b.m2 + d * d * a.n * fb;
  return r;
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const float* __restrict__ x, float* __restrict__ partial,
                  int HW, int C, int G, int S, int P) {
  const int s = blockIdx.x, g = blockIdx.y, n = blockIdx.z;
  const int cpg = C / G;
  const int p0 = s * P;
  const int p1 = min(HW, p0 + P);
  const int cnt = max(0, p1 - p0) * cpg;
  const float* base = x + ((size_t)n * HW + p0) * C + (size_t)g * cpg;

  Welford w = {0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < cnt; e += kThreads) {
    const int p = e / cpg, k = e - p * cpg;
    const float v = __ldg(base + (size_t)p * C + k);
    w.n += 1.f;
    const float d = v - w.mean;
    w.mean += d / w.n;
    w.m2 += d * (v - w.mean);
  }
  for (int off = 16; off > 0; off >>= 1) {
    Welford o;
    o.n = __shfl_down_sync(0xffffffffu, w.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, w.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, w.m2, off);
    w = merge(w, o);
  }
  __shared__ Welford warp_part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = w;
  __syncthreads();
  if (threadIdx.x == 0) {
    Welford t = warp_part[0];
    for (int i = 1; i < kThreads / 32; ++i) t = merge(t, warp_part[i]);
    float* dst = partial + (((size_t)n * G + g) * S + s) * 3;
    dst[0] = t.n;
    dst[1] = t.mean;
    dst[2] = t.m2;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ partial,
                                   float* __restrict__ stats, int NG, int S,
                                   float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NG) return;
  const float* src = partial + (size_t)i * S * 3;
  Welford t = {src[0], src[1], src[2]};
  for (int s = 1; s < S; ++s) {
    Welford o = {src[3 * s], src[3 * s + 1], src[3 * s + 2]};
    t = merge(t, o);
  }
  const float var = t.n > 0.f ? t.m2 / t.n : 0.f;
  stats[2 * i] = t.mean;
  stats[2 * i + 1] = 1.f / sqrtf(var + eps);
}

}  // namespace

// x [N, HW, C] fp32; partial: N*G*S*3 fp32 scratch; stats [N, G, 2] fp32
// (mean, 1/sqrt(var+eps)).  P = ceil(HW / S) pixels per slice.
extern "C" int gn_stats_launch(const float* x, float* partial, float* stats,
                               int N, int HW, int C, int G, int S, float eps,
                               cudaStream_t stream) {
  if (N <= 0 || HW <= 0 || G <= 0 || C % G != 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const int P = (HW + S - 1) / S;
  gn_partial_kernel<<<dim3(S, G, N), kThreads, 0, stream>>>(x, partial, HW,
                                                            C, G, S, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NG = N * G;
  gn_finalize_kernel<<<(NG + 127) / 128, 128, 0, stream>>>(partial, stats,
                                                           NG, S, eps);
  return (int)cudaGetLastError();
}
