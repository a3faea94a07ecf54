// The chunked RWKV-6 walk shared by the forward (rwkv6_scan.cu, the
// prefill kernel described there) and the backward (rwkv6_scan_bwd.cu):
// rwkv6_chunk_kernel<T, DP, SAVE>.  SAVE = false is the forward: the output
// and the final state.  SAVE = true is the backward's recompute of the
// forward's states: the same walk, no output, and the state at the start of
// every 16-token sub-chunk written out (then the final state after them), so
// the states it writes are the bits the forward holds there.

#pragma once

#include <type_traits>

#include "attn_common.cuh"
#include "hopper_mma.cuh"

namespace {

using tc::Split;
using tc::split_tf32;

constexpr int C = 16;      // tokens per sub-chunk
constexpr int AS = 20;     // row stride of A in shared memory (conflict-free B fragments)

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float ld(const T* p) { return to_f(*p); }

// block shape of the chunked kernel for a padded head dim DP: NT value
// columns per block, 16 per warp, and the key dim split in two halves over
// two warps per 16 columns
template <int DP>
struct Tile {
  static constexpr int NT = DP < 64 ? DP : 64;
  static constexpr int JW = NT / 16;          // warps along the value columns
  static constexpr int WARPS = 2 * JW;        // x 2 key halves
  static constexpr int THREADS = 32 * WARPS;
};

template <typename T, int DP>
struct Smem {
  static constexpr int NT = Tile<DP>::NT;
  T r[2][C * DP], k[2][C * DP], v[2][C * DP];   // staged spans [t * d + i]
  float w[2][C * DP];
  float rf[C][DP], kf[C][DP], dec[C][DP];
  uint32_t rdh[C][DP + 8], rdl[C][DP + 8];      // r (.) D, hi / lo
  uint32_t krh[C][DP + 8], krl[C][DP + 8];      // k (.) decay to the sub-chunk end
  uint32_t vh[C][NT + 8], vl[C][NT + 8];        // this block's columns of v
  uint32_t ah[C][AS], al[C][AS];                // A [t][s]
  float dl[DP], us[DP];                         // D_16, u
  float ys[2][C][NT + 4];                       // the output tile, per key half
};

// c[j] += a b[j] where a is exact in TF32 (a bf16 value: its lo half is
// zero): a b_lo then a b_hi in a fresh fragment, added to c[j] -- the
// products of 3xTF32 that are not zero, in its order
template <int N>
__device__ __forceinline__ void mma_exact_a(float (&c)[N][4], const uint32_t (&a)[4],
                                            const uint32_t (&bhi)[N][2],
                                            const uint32_t (&blo)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) tc::mma_tf32_zero(d[j], a, blo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) tc::mma_tf32(d[j], a, bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += d[j][i];
}

// N consecutive floats of shared memory (N = 1, 2, 4; aligned to N)
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x;
    x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

// one halving step of reduce_scatter16: the first N values, lane bit N
// choosing the half a lane keeps and adds its partner's to
template <int N>
__device__ __forceinline__ void halve(float (&x)[16], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = up ? x[j] : x[j + N / 2];
    const float keep = up ? x[j + N / 2] : x[j];
    x[j] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// sum of 16 values over the 32 lanes of a warp, scattered: lane l ends with
// the full sum of value l >> 1 (halving exchanges over lane bits 16, 8, 4,
// 2, then the pair over bit 1; a fixed order)
__device__ __forceinline__ float reduce_scatter16(float (&x)[16], int lane) {
  halve<16>(x, lane);
  halve<8>(x, lane);
  halve<4>(x, lane);
  halve<2>(x, lane);
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 y);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 y) {
  *reinterpret_cast<float4*>(p) = y;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 y) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(attn::pack_bf16x2(y.x, y.y), attn::pack_bf16x2(y.z, y.w));
}

// r, k, v, w of `rows` tokens (the span at element `at`) into buffer `buf`:
// cp.async in 16-byte pieces where every row starts 16-byte aligned, else
// plain loads
template <typename T, int DP>
__device__ __forceinline__ void stage(Smem<T, DP>& sm, int buf, const T* r, const T* k,
                                      const T* v, const float* w, size_t at, int rows, int D,
                                      int vec) {
  constexpr int THREADS = Tile<DP>::THREADS;
  const int n = rows * D;
  if (vec) {
    constexpr int TE = 16 / sizeof(T);
    for (int p = threadIdx.x * TE; p < n; p += THREADS * TE) {
      tc::cp_async16(&sm.r[buf][p], r + at + p, true);
      tc::cp_async16(&sm.k[buf][p], k + at + p, true);
      tc::cp_async16(&sm.v[buf][p], v + at + p, true);
    }
    for (int p = threadIdx.x * 4; p < n; p += THREADS * 4)
      tc::cp_async16(&sm.w[buf][p], w + at + p, true);
  } else {
    for (int e = threadIdx.x; e < n; e += THREADS) {
      sm.r[buf][e] = r[at + e];
      sm.k[buf][e] = k[at + e];
      sm.v[buf][e] = v[at + e];
      sm.w[buf][e] = w[at + e];
    }
  }
}

// a sub-chunk's output (`rows` tokens at element `at`): the two key halves'
// parts added in order, four columns of one token per thread
template <typename T, int DP>
__device__ __forceinline__ void store_out(const Smem<T, DP>& sm, T* out, size_t at, int col0,
                                          int rows, int D, int vec) {
  constexpr int NT = Tile<DP>::NT;
  const int tok = threadIdx.x / (NT / 4), jj = 4 * (threadIdx.x % (NT / 4)), j = col0 + jj;
  if (tok >= rows) return;
  const float4 a = *reinterpret_cast<const float4*>(&sm.ys[0][tok][jj]);
  const float4 b = *reinterpret_cast<const float4*>(&sm.ys[1][tok][jj]);
  const float4 y = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  T* o = out + at + (size_t)tok * D + j;
  if (vec) {
    if (j < D) store4(o, y);
  } else {
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j + c < D) attn::store1(o + c, yv[c]);
  }
}

// SAVE: sT holds nchunks + 1 states a pair, [pair][c][D][D]: the state
// before sub-chunk c, then the final state; out is not written
template <typename T, int DP, bool SAVE>
__global__ void __launch_bounds__(Tile<DP>::THREADS, 2)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, const float* __restrict__ u, const float* s0,
                   T* __restrict__ out, float* sT, int H, int Tn, int D, int vec) {
  using TL = Tile<DP>;
  constexpr int NT = TL::NT, THREADS = TL::THREADS, WARPS = TL::WARPS;
  constexpr int NQ = DP / 16;                   // 8-wide key slices per key half
  constexpr int QG = NQ < 2 ? NQ : 2;           // slices per group of the inter product
  constexpr int CPL = DP >= 32 ? DP / 32 : 1;   // key columns per lane in A
  constexpr bool FP32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, DP>& sm = *reinterpret_cast<Smem<T, DP>*>(smem_raw);

  const int tiles = (D + NT - 1) / NT;
  const int pair = blockIdx.x / tiles, col0 = (blockIdx.x % tiles) * NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp % TL::JW) * 16;      // the warp's first column in the tile
  const int hw = warp / TL::JW;             // its key half, keys [8 q0, 8 (q0 + NQ))
  const int q0 = hw * NQ;
  const int i0 = lane * CPL;                // A's key columns of this lane
  const int ia = i0 < DP ? i0 : 0;
  const size_t seq = (size_t)pair * Tn * D;
  const size_t sbase = (size_t)pair * D * D;
  const int nchunks = (Tn + C - 1) / C;

  for (int i = tid; i < DP; i += THREADS)
    sm.us[i] = i < D ? u[(size_t)(pair % H) * D + i] : 0.f;
  for (int e = tid; e < C * AS; e += THREADS) {   // A's upper triangle stays 0
    sm.ah[e / AS][e % AS] = 0u;
    sm.al[e / AS][e % AS] = 0u;
  }

  // S^T in the accumulator layout of the state product: S[q][e] holds
  // S[i][j] at i = 8 (q0 + q) + 2 t4 + (e & 1), j = col0 + m0 + g + 8 (e >> 1)
  float S[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * (q0 + q) + 2 * t4 + (e & 1), j = col0 + m0 + g + 8 * (e >> 1);
      S[q][e] = (s0 != nullptr && i < D && j < D) ? s0[sbase + (size_t)i * D + j] : 0.f;
    }

  stage(sm, 0, r, k, v, w, seq, min(C, Tn), D, vec);
  tc::cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * C, buf = c & 1, rows = min(C, Tn - t0);
    tc::cp_async_wait<0>();
    __syncthreads();   // this sub-chunk is staged; every warp is done with the last one
    if (c + 1 < nchunks)
      stage(sm, buf ^ 1, r, k, v, w, seq + (size_t)(t0 + C) * D, min(C, Tn - t0 - C), D, vec);
    tc::cp_async_commit();
    if constexpr (SAVE) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * (q0 + q) + 2 * t4 + (e & 1), j = col0 + m0 + g + 8 * (e >> 1);
          if (i < D && j < D)
            sT[((size_t)pair * (nchunks + 1) + c) * D * D + (size_t)i * D + j] = S[q][e];
        }
    } else if (c > 0) {
      store_out(sm, out, seq + (size_t)(t0 - C) * D, col0, C, D, vec);
    }

    // decays, and r, k, v in fp32 (padded tokens and columns: 0, dec 1)
    for (int e = tid; e < C * DP; e += THREADS) {
      const int t = e / DP, i = e % DP, at = t * D + i;
      const bool ok = t < rows && i < D;
      sm.rf[t][i] = ok ? to_f(sm.r[buf][at]) : 0.f;
      sm.kf[t][i] = ok ? to_f(sm.k[buf][at]) : 0.f;
      sm.dec[t][i] = ok ? expf(-expf(sm.w[buf][at])) : 1.f;
    }
    for (int e = tid; e < C * NT; e += THREADS) {
      const int t = e / NT, jj = e % NT, j = col0 + jj;
      const float x = (t < rows && j < D) ? to_f(sm.v[buf][t * D + j]) : 0.f;
      if constexpr (FP32) {
        const Split s = split_tf32(x);
        sm.vh[t][jj] = s.hi;
        sm.vl[t][jj] = s.lo;
      } else {
        sm.vh[t][jj] = __float_as_uint(x);   // bf16 is exact in TF32
      }
    }
    __syncthreads();

    // the two decay scans, one key column each: r_t (.) D_t, D_16, and
    // k_s (.) prod_{m>s} dec_m
    for (int it = tid; it < 2 * DP; it += THREADS) {
      float x = 1.f;
      if (it < DP) {
        const int i = it;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const Split s = split_tf32(sm.rf[t][i] * x);
          sm.rdh[t][i] = s.hi;
          sm.rdl[t][i] = s.lo;
          x *= sm.dec[t][i];
        }
        sm.dl[i] = x;
      } else {
        const int i = it - DP;
#pragma unroll
        for (int t = C - 1; t >= 0; --t) {
          const Split s = split_tf32(sm.kf[t][i] * x);
          sm.krh[t][i] = s.hi;
          sm.krl[t][i] = s.lo;
          x *= sm.dec[t][i];
        }
      }
    }
    // A below the diagonal, pair by pair: warp turn p takes rows s = p and
    // 15 - p, 15 pairs (t, s) together in 16 slots; each lane sums CPL key
    // columns, the decay from s to t carried as a running product; then
    // the slots are summed over the lanes in a fixed order
    if constexpr (!SAVE) {
#pragma unroll
      for (int pw = 0; pw < C / 2 / WARPS; ++pw) {
        const int p = warp + pw * WARPS;
        const int split = C - 1 - p;          // slots [0, split): row p, t = p + 1 + slot
        float kp[CPL], k2[CPL], acc[16];
        lds(kp, &sm.kf[p][ia]);
        lds(k2, &sm.kf[C - 1 - p][ia]);
#pragma unroll
        for (int sl = 0; sl < C - 1; ++sl) {
          const int t = sl < split ? p + 1 + sl : sl + 1;
#pragma unroll
          for (int c8 = 0; c8 < CPL; ++c8) kp[c8] = sl == split ? k2[c8] : kp[c8];
          float rr[CPL], dd[CPL], a = 0.f;
          lds(rr, &sm.rf[t][ia]);
          lds(dd, &sm.dec[t][ia]);
#pragma unroll
          for (int c8 = 0; c8 < CPL; ++c8) {
            a = fmaf(rr[c8], kp[c8], a);
            kp[c8] *= dd[c8];
          }
          acc[sl] = i0 < DP ? a : 0.f;
        }
        acc[C - 1] = 0.f;
        const float sum = reduce_scatter16(acc, lane);
        const int sl = lane >> 1;
        if ((lane & 1) == 0 && sl < C - 1) {
          const int t = sl < split ? p + 1 + sl : sl + 1, s = sl < split ? p : C - 1 - p;
          const Split sp = split_tf32(sum);
          sm.ah[t][s] = sp.hi;
          sm.al[t][s] = sp.lo;
        }
      }
      // A's diagonal, the bonus sum_i r_ti u_i k_ti: tokens warp + n WARPS,
      // each summed over the lanes in a fixed order
      {
        constexpr int BT = C / WARPS;
        float a[BT];
#pragma unroll
        for (int n = 0; n < BT; ++n) {
          const int t = warp + n * WARPS;
          float rr[CPL], kk[CPL], uu[CPL];
          lds(rr, &sm.rf[t][ia]);
          lds(kk, &sm.kf[t][ia]);
          lds(uu, &sm.us[ia]);
          a[n] = 0.f;
#pragma unroll
          for (int c8 = 0; c8 < CPL; ++c8) a[n] = fmaf(rr[c8] * uu[c8], kk[c8], a[n]);
          a[n] = i0 < DP ? a[n] : 0.f;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int n = 0; n < BT; ++n) a[n] += __shfl_xor_sync(0xffffffffu, a[n], o);
        if (lane == 0) {
#pragma unroll
          for (int n = 0; n < BT; ++n) {
            const int t = warp + n * WARPS;
            const Split sp = split_tf32(a[n]);
            sm.ah[t][t] = sp.hi;
            sm.al[t][t] = sp.lo;
          }
        }
      }
    }  // !SAVE
    __syncthreads();

    // inter: this key half's part of y^T [16 columns x 16 tokens] =
    // S^T (r (.) D)^T, 8 keys a slice, QG slices' products issued side by side
    float y[2][4] = {};
    if constexpr (!SAVE) {
#pragma unroll
      for (int qa = 0; qa < NQ; qa += QG) {
        uint32_t ahi[QG][4], alo[QG][4], bhi[QG][2][2], blo[QG][2][2];
#pragma unroll
        for (int qq = 0; qq < QG; ++qq) {
          const int q = qa + qq, kq = 8 * (q0 + q) + 2 * t4;
          const float af[4] = {S[q][0], S[q][2], S[q][1], S[q][3]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const Split s = split_tf32(af[e]);
            ahi[qq][e] = s.hi;
            alo[qq][e] = s.lo;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint2 h = *reinterpret_cast<const uint2*>(&sm.rdh[8 * nt + g][kq]);
            const uint2 l = *reinterpret_cast<const uint2*>(&sm.rdl[8 * nt + g][kq]);
            bhi[qq][nt][0] = h.x;
            bhi[qq][nt][1] = h.y;
            blo[qq][nt][0] = l.x;
            blo[qq][nt][1] = l.y;
          }
        }
        float d[QG][2][4];
#pragma unroll
        for (int qq = 0; qq < QG; ++qq)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) tc::mma_tf32_zero(d[qq][nt], alo[qq], bhi[qq][nt]);
#pragma unroll
        for (int qq = 0; qq < QG; ++qq)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) tc::mma_tf32(d[qq][nt], ahi[qq], blo[qq][nt]);
#pragma unroll
        for (int qq = 0; qq < QG; ++qq)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) tc::mma_tf32(d[qq][nt], ahi[qq], bhi[qq][nt]);
#pragma unroll
        for (int qq = 0; qq < QG; ++qq)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[nt][e] += d[qq][nt][e];
      }
    }  // !SAVE
    // v^T fragments (A operand of the intra and state products), 8 tokens a step
    uint32_t vah[2][4], val[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int s = 8 * ks + t4;
      vah[ks][0] = sm.vh[s][m0 + g];
      vah[ks][1] = sm.vh[s][m0 + g + 8];
      vah[ks][2] = sm.vh[s + 4][m0 + g];
      vah[ks][3] = sm.vh[s + 4][m0 + g + 8];
      if constexpr (FP32) {
        val[ks][0] = sm.vl[s][m0 + g];
        val[ks][1] = sm.vl[s][m0 + g + 8];
        val[ks][2] = sm.vl[s + 4][m0 + g];
        val[ks][3] = sm.vl[s + 4][m0 + g + 8];
      }
    }
    // intra: this key half takes the 8 tokens s of its step: y^T += v^T A^T
    if constexpr (!SAVE) {
      uint32_t bhi[2][2], blo[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        bhi[nt][0] = sm.ah[8 * nt + g][8 * hw + t4];
        bhi[nt][1] = sm.ah[8 * nt + g][8 * hw + t4 + 4];
        blo[nt][0] = sm.al[8 * nt + g][8 * hw + t4];
        blo[nt][1] = sm.al[8 * nt + g][8 * hw + t4 + 4];
      }
      uint32_t a[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = hw ? vah[1][e] : vah[0][e];
        alo[e] = FP32 ? (hw ? val[1][e] : val[0][e]) : 0u;
      }
      if constexpr (FP32)
        tc::mma_3xtf32<2>(y, a, alo, bhi, blo);
      else
        mma_exact_a<2>(y, a, bhi, blo);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sm.ys[hw][8 * nt + 2 * t4][m0 + g] = y[nt][0];
        sm.ys[hw][8 * nt + 2 * t4 + 1][m0 + g] = y[nt][1];
        sm.ys[hw][8 * nt + 2 * t4][m0 + g + 8] = y[nt][2];
        sm.ys[hw][8 * nt + 2 * t4 + 1][m0 + g + 8] = y[nt][3];
      }
    }  // !SAVE

    // state: S^T <- S^T (.)cols D_16 + v^T (k (.) decay to the end), one
    // fresh fragment per 8 keys over the 16 tokens, added with one rounding
    {
      float d[NQ][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bhi[NQ][2], blo[NQ][2];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int i = 8 * (q0 + q) + g;
          bhi[q][0] = sm.krh[8 * ks + t4][i];
          bhi[q][1] = sm.krh[8 * ks + t4 + 4][i];
          blo[q][0] = sm.krl[8 * ks + t4][i];
          blo[q][1] = sm.krl[8 * ks + t4 + 4][i];
        }
        if constexpr (FP32) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (ks == 0)
              tc::mma_tf32_zero(d[q], val[ks], bhi[q]);
            else
              tc::mma_tf32(d[q], val[ks], bhi[q]);
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) tc::mma_tf32(d[q], vah[ks], blo[q]);
        } else {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (ks == 0)
              tc::mma_tf32_zero(d[q], vah[ks], blo[q]);
            else
              tc::mma_tf32(d[q], vah[ks], blo[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) tc::mma_tf32(d[q], vah[ks], bhi[q]);
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 dl = *reinterpret_cast<const float2*>(&sm.dl[8 * (q0 + q) + 2 * t4]);
        S[q][0] = fmaf(dl.x, S[q][0], d[q][0]);
        S[q][1] = fmaf(dl.y, S[q][1], d[q][1]);
        S[q][2] = fmaf(dl.x, S[q][2], d[q][2]);
        S[q][3] = fmaf(dl.y, S[q][3], d[q][3]);
      }
    }
  }
  if constexpr (!SAVE) {
    __syncthreads();
    store_out(sm, out, seq + (size_t)(nchunks - 1) * C * D, col0, Tn - (nchunks - 1) * C, D, vec);
  }
  const size_t fbase = SAVE ? ((size_t)pair * (nchunks + 1) + nchunks) * D * D : sbase;

#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * (q0 + q) + 2 * t4 + (e & 1), j = col0 + m0 + g + 8 * (e >> 1);
      if (i < D && j < D) sT[fbase + (size_t)i * D + j] = S[q][e];
    }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename T, int DP, bool SAVE = false>
int launch_chunk(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const float* s0, void* out, float* sT, int NH, int H, int Tn, int D,
                 cudaStream_t stream) {
  constexpr int NT = Tile<DP>::NT;
  const int smem = (int)sizeof(Smem<T, DP>);
  auto kern = rwkv6_chunk_kernel<T, DP, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = D % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                  aligned16(out);
  kern<<<NH * ((D + NT - 1) / NT), Tile<DP>::THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(out), sT, H, Tn, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace
