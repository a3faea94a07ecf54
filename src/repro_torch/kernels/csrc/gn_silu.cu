// Standalone GroupNorm + affine + SiLU, NHWC fp32, the apply pass.
//
// Replaces src/repro/kernels/gn_silu.py::group_norm_silu (_apply_kernel;
// its _stats_kernel is replaced by gn_stats.cu, which the Python wrapper
// launches first).  It runs where a GroupNorm + SiLU is not followed by a
// conv that could take it as a prologue: the encoder's norm_out (64x64x512
// per 512x512 image, 8.4 MB, resident in the 50 MB L2) and the float
// decode's norm_out (512x512x128, 134 MB read and 134 MB written).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with about ten flops and one exponential in between (the special-function
// unit's exp and a fast divide, as the fused conv's prologue).  Design:
// float4 loads and stores along C (C % 4 == 0, checked by the wrapper and
// here).  Each block row of the grid (blockIdx.y) is one image; the float4
// quads of that image are walked by a grid-stride loop whose stride is a
// multiple of C/4, so a thread keeps the same four channels for its whole
// loop and reads their (mean, rstd, gamma, beta) once, before it.  Four
// quads are loaded before any is used, so four loads per thread are in
// flight.  An output larger than the L2 is written with streaming stores
// (evict-first), so it does not push out lines that other work reuses.
// The grid is sized to keep every SM busy (8 blocks per SM over all images,
// 32 where the tensor streams from memory: the fastest on the card) and
// never exceeds the work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <bool STREAM>
__global__ void __launch_bounds__(kThreads)
gn_apply_silu_kernel(const float4* __restrict__ x,
                     const float* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float4* __restrict__ out,
                     long long quads, int C4, int G, int cpg) {
  const int n = blockIdx.y;
  const long long stride = (long long)gridDim.x * kThreads;  // % C4 == 0
  long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int c = (int)(q % C4) * 4;
  float mean[4], rstd[4], ga[4], be[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gi = n * G + (c + j) / cpg;
    mean[j] = __ldg(stats + 2 * gi);
    rstd[j] = __ldg(stats + 2 * gi + 1);
    ga[j] = __ldg(gamma + c + j);
    be[j] = __ldg(beta + c + j);
  }
  const float4* xi = x + (size_t)n * quads;
  float4* oi = out + (size_t)n * quads;
  auto apply = [&](float4 v) {
    float t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = fmaf((t[j] - mean[j]) * rstd[j], ga[j], be[j]);
      t[j] = __fdividef(u, 1.f + __expf(-u));   // u * sigmoid(u)
    }
    return make_float4(t[0], t[1], t[2], t[3]);
  };
  auto store = [&](long long i, float4 v) {
    if (STREAM) __stcs(oi + i, v);
    else oi[i] = v;
  };
  for (; q + (kUnroll - 1) * stride < quads; q += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = __ldg(xi + q + k * stride);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) store(q + k * stride, apply(v[k]));
  }
  for (; q < quads; q += stride) store(q, apply(__ldg(xi + q)));
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// outputs above this many bytes go out with streaming stores
constexpr long long kStreamBytes = 32LL << 20;

}  // namespace

// x, out [N, HW, C] fp32 (16-byte aligned); stats [N, G, 2] (mean, rstd)
// from gn_stats_launch; gamma, beta [C].
extern "C" int gn_silu_launch(const float* x, const float* stats,
                              const float* gamma, const float* beta,
                              float* out, int N, int HW, int C, int G,
                              cudaStream_t stream) {
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || C % 4 != 0 || G <= 0 ||
      C % G != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int C4 = C / 4;
  const long long quads = (long long)HW * C4;
  // the stride gridDim.x * kThreads must be a multiple of C4
  const int step = C4 / gcd(kThreads, C4);
  const long long need = (quads + kThreads - 1) / kThreads;
  // blocks per SM in all: more where the tensor streams from memory
  const bool stream_out = quads * 16 * N > kStreamBytes;
  const long long per_sm = stream_out ? 32 : 8;
  long long want = (per_sm * sms + N - 1) / N;
  if (want > need) want = need;
  long long bx = (want + step - 1) / step * step;
  if (bx > 2147483647LL) bx = 2147483647LL / step * step;
  const dim3 grid((unsigned)bx, N);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (stream_out)
    gn_apply_silu_kernel<true><<<grid, kThreads, 0, stream>>>(
        x4, stats, gamma, beta, o4, quads, C4, G, C / G);
  else
    gn_apply_silu_kernel<false><<<grid, kThreads, 0, stream>>>(
        x4, stats, gamma, beta, o4, quads, C4, G, C / G);
  return (int)cudaGetLastError();
}
