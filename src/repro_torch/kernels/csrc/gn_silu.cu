// Standalone GroupNorm + affine + SiLU, NHWC fp32, the apply pass.
//
// Replaces src/repro/kernels/gn_silu.py::group_norm_silu (_apply_kernel;
// its _stats_kernel is replaced by gn_stats.cu, which the Python wrapper
// launches first).  It runs where a GroupNorm + SiLU is not followed by a
// conv that could take it as a prologue: the encoder's norm_out (64x64x512
// per 512x512 image) and the float decode's norm_out (512x512x128).
//
// Bound on the H100: bytes.  Each element is read once and written once
// with about ten flops and one expf in between.  Design: float4 loads and
// stores along C (C % 4 == 0, checked by the wrapper and here).  Each block
// row of the grid (blockIdx.y) is one image; the float4 quads of that image
// are walked by a grid-stride loop whose stride is a multiple of C/4, so a
// thread keeps the same four channels for its whole loop and reads their
// (mean, rstd, gamma, beta) once, before it.  The grid is sized to keep
// every SM busy (a few blocks per SM over all images) and never exceeds
// the work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
  for (; q < quads; q += stride) {
    const float4 v = __ldg(xi + q);
    float t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = (t[j] - mean[j]) * rstd[j] * ga[j] + be[j];
      t[j] = u / (1.f + expf(-u));
    }
    oi[q] = make_float4(t[0], t[1], t[2], t[3]);
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

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
  long long want = (8LL * sms + N - 1) / N;   // ~8 blocks per SM in all
  if (want > need) want = need;
  long long bx = (want + step - 1) / step * step;
  if (bx > 2147483647LL) bx = 2147483647LL / step * step;
  gn_apply_silu_kernel<<<dim3((unsigned)bx, N), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), stats, gamma, beta,
      reinterpret_cast<float4*>(out), quads, C4, G, C / G);
  return (int)cudaGetLastError();
}
