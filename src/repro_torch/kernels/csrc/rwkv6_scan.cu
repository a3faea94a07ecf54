// RWKV-6 (Finch) linear-attention recurrence, per (sequence, head):
//
//   out_t = r_t . (S + u (x) (k_t (x) v_t)),   S <- diag(exp(-exp(w_t))) S + k_t (x) v_t
//
// with the [d, d] state S in fp32.  r/k/v fp32 or bf16, w and u fp32, the
// output in r's type (bf16 rounded to nearest even), the final state fp32.
//
// Replaces src/repro/kernels/rwkv6_scan.py::rwkv6_scan (_rwkv_kernel), the
// time mix of every RWKV-6 layer (the JAX model reaches the same function
// through its chunked XLA form, models/ssm.py::rwkv6_chunked).
//
// Bound on the H100: at the prefill, fp32 operations (about 5 d^2 per token
// and head against 4 d elements read); at a decode step (t = 1), reading and
// writing the state.  The work is a long sequential recurrence, so the
// parallelism is across (sequence, head) pairs and across the d value
// columns of one pair.  Design: thread j of a pair owns column j of S in d
// registers for the whole sequence, so out_t[j] = sum_i r_i S_ij + a_t v_j
// (a_t = sum_i r_i u_i k_i, one scalar per token) and S_ij <- dec_i S_ij +
// k_i v_j need no cross-thread reduction.  A block holds 128 / DP pairs (DP:
// d rounded up to a power of two >= 8), 128 threads; at d = 64 and batch 4
// that is 128 blocks for 256 pairs on 132 SMs.  Tokens are taken CH = 8 at a
// time: each thread loads one column of the next chunk's r, k, v, w into
// registers while the current chunk computes, so device-memory latency is
// off the serial path; r, k and dec = exp(-exp(w)) go through shared memory
// (every thread of the pair reads all d of them), v stays in the registers
// of the thread that owns its column.  a_t is summed in two fixed-order
// steps (CH-term partials, then the DP / CH partials).  Tokens past t are
// padded with r = k = v = 0 and dec = 1, which leaves S exactly unchanged,
// so the token loop has no branch.  Each thread reads its column of the
// initial state before it writes any of the final state, and no other
// thread touches that column: the final state may alias the initial one
// (decode updates its cache in place).  A pair's arithmetic does not depend
// on which block or slot runs it: results are independent of the batch.

#include "attn_common.cuh"

namespace {

constexpr int THREADS = 128, CH = 8;

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ void fetch(const T* r, const T* k, const T* v,
                                      const float* w, size_t seq, int t0,
                                      int Tn, int D, int j, bool live,
                                      float (&pr)[CH], float (&pk)[CH],
                                      float (&pv)[CH], float (&pw)[CH]) {
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const bool in = live && t0 + m < Tn;
    const size_t at = seq + (size_t)(t0 + m) * D + j;
    pr[m] = in ? ld(r + at) : 0.f;
    pk[m] = in ? ld(k + at) : 0.f;
    pv[m] = in ? ld(v + at) : 0.f;
    pw[m] = in ? __ldg(w + at) : -INFINITY;   // dec = exp(-exp(-inf)) = 1
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* s0, T* __restrict__ out,
             float* sT, int NH, int H, int Tn, int D) {
  constexpr int PAIRS = THREADS / DP, SEGS = DP / CH;
  static_assert(PAIRS * DP == THREADS && SEGS * CH == DP, "tiling");
  __shared__ __align__(16) float rs[PAIRS][CH][DP];
  __shared__ __align__(16) float ks[PAIRS][CH][DP];
  __shared__ __align__(16) float ds[PAIRS][CH][DP];
  __shared__ float us[PAIRS][DP];
  __shared__ float part[PAIRS][SEGS][CH];
  __shared__ float bonus[PAIRS][CH];

  const int slot = threadIdx.x / DP, j = threadIdx.x % DP;
  const int pair = blockIdx.x * PAIRS + slot;
  const bool pair_live = pair < NH;
  const bool live = pair_live && j < D;   // this thread owns column j
  const size_t seq = (size_t)(pair_live ? pair : 0) * Tn * D;

  us[slot][j] = live ? __ldg(u + (size_t)(pair % H) * D + j) : 0.f;

  float S[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i)
    S[i] = (live && s0 != nullptr && i < D)
               ? s0[((size_t)pair * D + i) * D + j] : 0.f;

  // this thread's column of the next chunk: CH tokens of r, k, v, w
  float pr[CH], pk[CH], pv[CH], pw[CH];
  fetch(r, k, v, w, seq, 0, Tn, D, j, live, pr, pk, pv, pw);

  for (int t0 = 0; t0 < Tn; t0 += CH) {
    __syncthreads();                 // the last chunk's reads are done
    float vc[CH];
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      rs[slot][m][j] = pr[m];
      ks[slot][m][j] = pk[m];
      ds[slot][m][j] = expf(-expf(pw[m]));
      vc[m] = pv[m];
    }
    __syncthreads();
    if (t0 + CH < Tn)                  // in flight while this chunk computes
      fetch(r, k, v, w, seq, t0 + CH, Tn, D, j, live, pr, pk, pv, pw);
    {                                   // a_t: CH-term partials
      const int tok = j % CH, seg = j / CH;
      float p = 0.f;
#pragma unroll
      for (int q = 0; q < CH; ++q) {
        const int i = seg * CH + q;
        p = fmaf(rs[slot][tok][i] * us[slot][i], ks[slot][tok][i], p);
      }
      part[slot][seg][tok] = p;
    }
    __syncthreads();
    if (j < CH) {
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < SEGS; ++s) a += part[slot][s][j];
      bonus[slot][j] = a;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const float vj = vc[m];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < DP; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[slot][m][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[slot][m][i]);
        const float4 d4 = *reinterpret_cast<const float4*>(&ds[slot][m][i]);
        acc0 = fmaf(r4.x, S[i], acc0);
        acc1 = fmaf(r4.y, S[i + 1], acc1);
        acc2 = fmaf(r4.z, S[i + 2], acc2);
        acc3 = fmaf(r4.w, S[i + 3], acc3);
        S[i] = fmaf(d4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(d4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(d4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(d4.w, S[i + 3], k4.w * vj);
      }
      if (live && t0 + m < Tn)
        attn::store1(out + seq + (size_t)(t0 + m) * D + j,
                     ((acc0 + acc1) + (acc2 + acc3)) + bonus[slot][m] * vj);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DP; ++i)
      if (i < D) sT[((size_t)pair * D + i) * D + j] = S[i];
  }
}

template <typename T, int DP>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* out, float* sT, int NH,
           int H, int Tn, int D, cudaStream_t stream) {
  constexpr int PAIRS = THREADS / DP;
  const int blocks = (NH + PAIRS - 1) / PAIRS;
  rwkv6_kernel<T, DP><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(out), sT, NH, H,
      Tn, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, void* out, float* sT, int NH,
             int H, int Tn, int D, cudaStream_t stream) {
  if (D <= 8) return launch<T, 8>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (D <= 16) return launch<T, 16>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (D <= 32) return launch<T, 32>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (D <= 64) return launch<T, 64>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  return launch<T, 128>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
}

}  // namespace

// r, k, v [NH, Tn, D] of one type (dtype 0 = fp32, 1 = bf16), w [NH, Tn, D]
// fp32, u [H, D] fp32 (pair p uses head p % H), s0 [NH, D, D] fp32 or null
// (zeros), out [NH, Tn, D] in r's type, sT [NH, D, D] fp32 (may equal s0);
// all contiguous.  1 <= D <= 128.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const float* w, const float* u,
                                 const float* s0, void* out, float* sT,
                                 int NH, int H, int Tn, int D, int dtype,
                                 cudaStream_t stream) {
  if (NH <= 0 || H <= 0 || NH % H != 0 || Tn <= 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D,
                                   stream);
  return (int)cudaErrorInvalidValue;
}
