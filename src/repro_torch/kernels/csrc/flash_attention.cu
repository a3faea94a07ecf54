// Online-softmax attention: out = softmax(q k^T * scale + mask) v with no
// [Sq, Skv] matrix in device memory.  fp32 or bf16 inputs, fp32 softmax and
// accumulation, output in the input type.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel) in full: the VAE mid-block's single head over the H*W tokens
// of the latent grid (non-causal, d = C = 512, fp32) and the LM prefill's
// attention (causal, optional sliding window, grouped-query heads, d = 128,
// bf16).  Positions align at the sequence end: query row i sits at
// i + Skv - Sq; the mask keeps k <= q (causal) and k > q - window.  A q head
// bh reads kv head (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv), as the Pallas
// kernel's index map does, with no repeated k/v in memory.  A row with no
// key left (only possible with Sq > Skv) gives 0.
//
// Bound on the H100: operations (2 * Sq * Skv * d FMAs each for q k^T and
// p v against O(S * d) bytes).  Design: a block owns BQ = 64 queries and
// DV = 128 output columns; for every BKV = 64 keys it computes the logits
// over all of d (q and k streamed in DK = 32 slices through shared memory,
// widened to fp32 on load, a 4x4 register tile per thread), updates the
// running max and sum per row with warp shuffles, and accumulates p v for
// its 128 columns (a 4x8 register tile).  Causal and window masks bound the
// kv loop, so kv tiles wholly above the diagonal or below the window are
// never read: the causal prefill does half the work of a full one.  At
// d = 512 the output's d is split across blocks (q k^T recomputed once per
// 128-column slice: 4 * qk + pv = 2.5x the FLOPs of an unsplit kernel); at
// d <= 128 there is one slice.  Every query row is reduced in a fixed order
// by the same threads, so the result does not depend on how many images or
// sequences share the launch.

#include "attn_common.cuh"

namespace {

using attn::load4;
using attn::store4;

constexpr int BQ = 64, BKV = 64, DV = 128, DK = 32, THREADS = 256;
constexpr int QS = BQ + 4, KS = BKV + 4, PS = BQ + 4, VS = DV + 4;
constexpr int SMEM_FLOATS = DK * QS + DK * KS + BKV * PS + BKV * VS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
          int Skv, int D, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [DK][QS]   q slice, transposed
  float* Ks = Qs + DK * QS;      // [DK][KS]   k slice, transposed
  float* Ps = Ks + DK * KS;      // [BKV][PS]  probabilities, transposed
  float* Vs = Ps + BKV * PS;     // [BKV][VS]  v tile

  const int bh = blockIdx.z;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  // the longest causal rows first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, d0 = blockIdx.y * DV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int off = Skv - Sq;      // query row i sits at position i + off
  const T* Q = q + (size_t)bh * Sq * D;
  const T* K = k + (size_t)kvh * Skv * D;
  const T* V = v + (size_t)kvh * Skv * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys any row of this tile may see
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, min(q0 + BQ, Sq) + off);
  if (window > 0) kv_lo = max(0, q0 + off - window + 1) / BKV * BKV;

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BKV) {
    // -- logits s = q k^T over the full head dim -----------------------------
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dk0 = 0; dk0 < D; dk0 += DK) {
      for (int e = tid; e < BQ * DK / 4; e += THREADS) {
        const int row = e / (DK / 4), c4 = (e % (DK / 4)) * 4;
        const int gq = q0 + row, gk = kv0 + row, gd = dk0 + c4;
        const float4 qa = (gq < Sq && gd < D) ? load4(Q + (size_t)gq * D + gd) : zero4;
        const float4 ka = (gk < Skv && gd < D) ? load4(K + (size_t)gk * D + gd) : zero4;
        Qs[(c4 + 0) * QS + row] = qa.x;
        Qs[(c4 + 1) * QS + row] = qa.y;
        Qs[(c4 + 2) * QS + row] = qa.z;
        Qs[(c4 + 3) * QS + row] = qa.w;
        Ks[(c4 + 0) * KS + row] = ka.x;
        Ks[(c4 + 1) * KS + row] = ka.y;
        Ks[(c4 + 2) * KS + row] = ka.z;
        Ks[(c4 + 3) * KS + row] = ka.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + kk * QS + ty * 4);
        const float4 kb = *reinterpret_cast<const float4*>(Ks + kk * KS + tx * 4);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
      __syncthreads();
    }

    // -- online softmax: rows ty*4+i live on the 16 lanes sharing ty ---------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx * 4 + j;
        const bool keep = kpos < Skv && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      // no key kept yet: exponentiate against 0, so every p is exp(-inf) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        Ps[(tx * 4 + j) * PS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
    }

    // -- v tile for this block's DV output columns ---------------------------
    for (int e = tid; e < BKV * DV / 4; e += THREADS) {
      const int row = e / (DV / 4), c4 = (e % (DV / 4)) * 4;
      const int gk = kv0 + row, gd = d0 + c4;
      const float4 va = (gk < Skv && gd < D) ? load4(V + (size_t)gk * D + gd) : zero4;
      *reinterpret_cast<float4*>(Vs + row * VS + c4) = va;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(Ps + kk * PS + ty * 4);
      const float4 v0 = *reinterpret_cast<const float4*>(Vs + kk * VS + tx * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(Vs + kk * VS + 64 + tx * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // -- normalise and store ---------------------------------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = d0 + h * 64 + tx * 4;
      if (col < D) {   // D % 4 == 0: the whole quad is in range
        store4(orow + col,
               make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                           acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv));
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int N, int Hq,
           int Hkv, int Sq, int Skv, int D, float scale, int causal,
           int window, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, (D + DV - 1) / DV, N * Hq);
  fa_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q [N, Hq, Sq, D], k/v [N, Hkv, Skv, D], o [N, Hq, Sq, D], contiguous, all
// of one type: dtype 0 = fp32, 1 = bf16.  D % 4 == 0, Hq % Hkv == 0;
// window <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int N, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int window,
                                      int dtype, cudaStream_t stream) {
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Skv <= 0 || D <= 0 || D % 4 != 0 || N * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale, causal,
                         window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale,
                                 causal, window, stream);
  return (int)cudaErrorInvalidValue;
}
