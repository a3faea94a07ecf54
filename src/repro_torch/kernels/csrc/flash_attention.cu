// Online-softmax attention in fp32, non-causal, one kv head per q head:
// out = softmax(q k^T * scale) v with no [Sq, Skv] matrix in device memory.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel) for the case the VAE mid-block uses (vae/layers.py:152): one
// head over the H*W tokens of the latent grid, head dim d = C = 512.  The
// causal, sliding-window and GQA cases of the LM are not implemented; the
// Python wrapper refuses them.
//
// Bound on the H100: operations (2 * Sq * Skv * d FMAs each for q k^T and
// p v against O(S * d) bytes).  Design: d = 512 does not fit the usual
// tile (a 64 x 512 fp32 q tile alone is 128 KB), so the output's d is
// split across blocks.  A block owns BQ = 64 queries and DV = 128 output
// columns; for every BKV = 64 keys it computes the full logits over all of
// d (q and k streamed in DK = 32 slices through shared memory, a 4x4
// register tile per thread), updates the running max and sum per row with
// warp shuffles, and accumulates p v for its 128 columns (a 4x8 register
// tile).  The cost of the split is q k^T recomputed once per d slice: at
// d = 512 the kernel does 4 * qk + pv = 2.5x the FLOPs of an unsplit one.
// Every query row is reduced in a fixed order by the same threads, so the
// result does not depend on how many images share the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BKV = 64, DV = 128, DK = 32, THREADS = 256;
constexpr int QS = BQ + 4, KS = BKV + 4, PS = BQ + 4, VS = DV + 4;
constexpr int SMEM_FLOATS = DK * QS + DK * KS + BKV * PS + BKV * VS;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(THREADS)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
          int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [DK][QS]   q slice, transposed
  float* Ks = Qs + DK * QS;      // [DK][KS]   k slice, transposed
  float* Ps = Ks + DK * KS;      // [BKV][PS]  probabilities, transposed
  float* Vs = Ps + BKV * PS;     // [BKV][VS]  v tile

  const int bh = blockIdx.z;
  const int q0 = blockIdx.x * BQ, d0 = blockIdx.y * DV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* Q = q + (size_t)bh * Sq * D;
  const float* K = k + (size_t)bh * Skv * D;
  const float* V = v + (size_t)bh * Skv * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Skv; kv0 += BKV) {
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
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (kv0 + tx * 4 + j < Skv) ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tx * 4 + j) * PS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
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
    const float inv = 1.f / l[i];
    float* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = d0 + h * 64 + tx * 4;
      if (col < D) {   // D % 4 == 0: the whole float4 is in range
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv,
                        acc[i][4 * h + 2] * inv, acc[i][4 * h + 3] * inv);
      }
    }
  }
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Skv, D], o [BH, Sq, D], all fp32 and contiguous;
// D % 4 == 0.
extern "C" int flash_attention_launch(const float* q, const float* k,
                                      const float* v, float* o, int BH,
                                      int Sq, int Skv, int D, float scale,
                                      cudaStream_t stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 4 != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, (D + DV - 1) / DV, BH);
  fa_kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, Sq, Skv, D, scale);
  return (int)cudaGetLastError();
}
