// GroupNorm statistics: per-(n, group) mean and 1/sqrt(var + eps) of an
// NHWC fp32 tensor over (H, W, C/G).
//
// Replaces the statistics pass that the TPU kernels share:
// src/repro/kernels/gn_silu.py::_stats_kernel, as called by
// gn_silu_conv.py::gn_silu_conv3x3, output_epilogue.py::output_epilogue
// and gn_silu.py::group_norm_silu.  The TPU form sums x and x^2 and takes
// E[x^2] - E[x]^2; at 512x512x128 that is ~1 M elements per group and
// loses digits to cancellation.
//
// Bound on the H100: bytes (one read of the activation, a few flops per
// element): 134 MB, 0.040 ms at 3.35 TB/s, for the decoder's 512x512x128,
// where it takes 0.049 ms (device time; 63-93 % of the bound at the VAE's
// shapes but 39 % at 64x64x512, where its two launches' fixed cost
// dominates; chip_compare.py on an H100 80GB HBM3 at 700 W).
//
// Design.  Pass 1: one block per (pixel slice, group chunk, image) reads
// every channel of its pixels; a group chunk is all of C unless one pixel
// row of the block's groups outgrows the block.  Each thread keeps one
// unit of channels (a float4 where C % 4 == 0, C/G % 4 == 0 and x is
// 16-byte aligned; else one float, the scalar path, chosen by shape) and
// steps over pixels with a stride that is a multiple of the row, so a
// warp reads contiguous bytes (512 at C = 128: lane l owns group l) and
// every sector is fetched once.  Four loads (float4s, or floats on the
// scalar path) are issued before any is used, so four are in flight.
//
// Accuracy without a division per element: a batched, shifted Welford.
// Each load batch of m values is summed about the thread's running mean
// (about the batch's first value for the first batch): s1 = sum(v - K),
// s2 = sum((v - K)^2), then n += m, mean += s1 / n, M2 += s2 - s1^2 / n
// (exact algebra for any pivot K; one reciprocal per batch).  The shifted
// values are O(std), so the offset (x ~ 300 +- 1) never meets the
// squares, and s1^2 / n <= s2 keeps the subtraction mild.  Threads, then
// slices, merge with Chan's formula (one reciprocal of a known count per
// merge).  tests/test_torch_gn_stats.py models this arithmetic in fp32 on
// the CPU against float64 and the TPU kernel.
//
// Determinism: the block merges its threads in a fixed tree over their
// slots (pixel offset, then unit within the group), pass 2 merges the S
// slices of each (n, g) in a fixed tree (a block per (n, g)); no atomics.
// The slice count is the wrapper's function of (HW, C), never of N, so an
// image's statistics have the same bits at every batch size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Acc {
  float n, mean, m2;
};

// Every rounding below is spelled out (fmaf, __fmul_rn, which the
// compiler never contracts), so tests/test_torch_gn_stats.py can repeat
// the arithmetic bit for bit.

// Chan's merge: n = na + nb, mean = ma + d nb/n, M2 = M2a + M2b + d^2 na nb/n
__device__ __forceinline__ Acc chan(Acc a, Acc b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float f = __fmul_rn(b.n, __frcp_rn(n));
  const float d = b.mean - a.mean;
  const float t = __fmul_rn(__fmul_rn(d, d), a.n);
  return {n, fmaf(d, f, a.mean), fmaf(t, f, a.m2 + b.m2)};
}

constexpr int kThreads = 256;
constexpr int kBatch = 4;   // loads a thread issues before it uses one

// fold m values v[0..m) into a, summed about the running mean
template <int M>
__device__ __forceinline__ void fold(Acc& a, const float (&v)[M], int m) {
  if (a.n == 0.f) a.mean = v[0];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < m) {
      const float d = v[i] - a.mean;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  const float n = a.n + (float)m;
  const float e = __fmul_rn(s1, __frcp_rn(n));
  a.m2 += fmaf(-s1, e, s2);   // s2 - s1^2 / n
  a.mean += e;
  a.n = n;
}

// accumulate items k = 0, 1, ... < count (at(k) is the item's address),
// kBatch loads in flight per batch
template <bool V4, class At>
__device__ __forceinline__ void accumulate(Acc& a, int count, At at) {
  constexpr int VW = V4 ? 4 : 1;
  for (int k0 = 0; k0 < count; k0 += kBatch) {
    float v[kBatch * VW];
    const int valid = min(kBatch, count - k0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < valid) {
        if (V4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(at(k0 + j)));
          v[4 * j] = q.x;
          v[4 * j + 1] = q.y;
          v[4 * j + 2] = q.z;
          v[4 * j + 3] = q.w;
        } else {
          v[j] = __ldg(at(k0 + j));
        }
      }
    }
    fold(a, v, valid * VW);
  }
}

// grid (S, chunks, N).  A block covers pixels [s*P, min(HW, (s+1)*P)) and
// groups [g0, g0 + gpb) of one image; its U = groups * cpg / VW units.
template <bool V4>
__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const float* __restrict__ x, float* __restrict__ partial,
                  int HW, int C, int G, int S, int P, int gpb) {
  constexpr int VW = V4 ? 4 : 1;
  __shared__ Acc part[kThreads];
  const int s = blockIdx.x, n = blockIdx.z, tid = threadIdx.x;
  const int g0 = blockIdx.y * gpb;
  const int ng = min(gpb, G - g0);
  const int cpg = C / G, ug = cpg / VW;   // units per group
  const int U = ng * ug;
  const int p0 = min(HW, s * P);
  const int np = min(HW, p0 + P) - p0;
  const float* xb = x + ((size_t)n * HW + p0) * C + (size_t)g0 * cpg;

  Acc a = {0.f, 0.f, 0.f};
  int slot, nslots, gl;   // this thread's place in its group's merge tree
  if (U <= kThreads) {
    // the usual case: a fixed unit, pixels stepping by ppi
    const int ppi = kThreads / U;
    const int u = tid % U, pofs = tid / U;
    gl = u / ug;
    slot = pofs * ug + u % ug;
    nslots = ppi * ug;
    if (pofs < ppi) {
      const int cnt = np > pofs ? (np - pofs + ppi - 1) / ppi : 0;
      const float* t = xb + (size_t)pofs * C + u * VW;
      const size_t step = (size_t)ppi * C;
      accumulate<V4>(a, cnt, [&](int k) { return t + k * step; });
    } else {
      slot = nslots;   // idle: takes no part in the tree
    }
  } else {
    // one group wider than the block (gpb == 1): step over its items
    gl = 0;
    slot = tid;
    nslots = kThreads;
    const int items = np * U;
    const int cnt = items > tid ? (items - tid + kThreads - 1) / kThreads : 0;
    accumulate<V4>(a, cnt, [&](int k) {
      const int i = tid + k * kThreads, p = i / U;
      return xb + (size_t)p * C + (i - p * U) * VW;
    });
  }
  part[tid] = a;
  // fixed tree over each group's slots; slot -> thread is one-to-one
  auto thread_of = [&](int sl) {
    return U <= kThreads ? (sl / ug) * U + gl * ug + sl % ug : sl;
  };
  for (int w = 1; w < nslots; w *= 2) {
    __syncthreads();
    if (slot < nslots && slot % (2 * w) == 0 && slot + w < nslots)
      part[tid] = chan(part[tid], part[thread_of(slot + w)]);
  }
  __syncthreads();
  if (slot == 0) {
    float* dst = partial + (((size_t)n * G + g0 + gl) * S + s) * 3;
    dst[0] = part[tid].n;
    dst[1] = part[tid].mean;
    dst[2] = part[tid].m2;
  }
}

constexpr int kFinThreads = 128;

// a block per (n, g): thread t merges slices t, t + 128, ... in order,
// then the warps' shuffle trees, then warps 0..3 in order
__global__ void __launch_bounds__(kFinThreads)
gn_finalize_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                   int S, float eps) {
  const int i = blockIdx.x, tid = threadIdx.x;
  const float* src = partial + (size_t)i * S * 3;
  Acc a = {0.f, 0.f, 0.f};
  for (int s = tid; s < S; s += kFinThreads)
    a = chan(a, Acc{src[3 * s], src[3 * s + 1], src[3 * s + 2]});
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
    o.n = __shfl_down_sync(0xffffffffu, a.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, a.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, a.m2, off);
    a = chan(a, o);
  }
  __shared__ Acc warp_part[kFinThreads / 32];
  if ((tid & 31) == 0) warp_part[tid >> 5] = a;
  __syncthreads();
  if (tid == 0) {
    Acc t = warp_part[0];
    for (int w = 1; w < kFinThreads / 32; ++w) t = chan(t, warp_part[w]);
    const float var = t.n > 0.f ? fmaxf(t.m2 / t.n, 0.f) : 0.f;
    stats[2 * i] = t.mean;
    stats[2 * i + 1] = 1.f / sqrtf(var + eps);
  }
}

}  // namespace

// x [N, HW, C] fp32; partial: N*G*S*3 fp32 scratch, [n][g][s] (count,
// mean, M2); stats [N, G, 2] fp32 (mean, 1/sqrt(var+eps)).  Each of the S
// slices holds P = ceil(HW / S) pixels (the last ones may hold fewer).
extern "C" int gn_stats_launch(const float* x, float* partial, float* stats,
                               int N, int HW, int C, int G, int S, float eps,
                               cudaStream_t stream) {
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      S <= 0 || S > HW)
    return (int)cudaErrorInvalidValue;
  const int cpg = C / G;
  const bool v4 = C % 4 == 0 && cpg % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int ug = v4 ? cpg / 4 : cpg;
  const int gpb = ug >= kThreads ? 1 : min(G, kThreads / ug);
  const int chunks = (G + gpb - 1) / gpb;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const int P = (HW + S - 1) / S;
  const dim3 grid(S, chunks, N);
  if (v4)
    gn_partial_kernel<true><<<grid, kThreads, 0, stream>>>(x, partial, HW, C, G, S, P, gpb);
  else
    gn_partial_kernel<false><<<grid, kThreads, 0, stream>>>(x, partial, HW, C, G, S, P, gpb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<N * G, kFinThreads, 0, stream>>>(partial, stats, S, eps);
  return (int)cudaGetLastError();
}
