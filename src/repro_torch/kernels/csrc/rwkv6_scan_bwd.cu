// Backward of the RWKV-6 recurrence (rwkv6_scan.cu), per (sequence, head)
// pair: the gradients of rwkv6_scan(r, k, v, w, u, state) from the
// cotangents dO of its output and dS_T of its final state.  With S_t the
// state after token t, dec = exp(lw), lw = -exp(w), and dS_t the cotangent
// of S_t:
//
//   dS_{t-1} = diag(dec_t) dS_t + r_t dO_t^T                  (dS_0: dstate0)
//   dr_t = S_{t-1} dO_t + u (.) k_t c_t,   dk_t = dS_t v_t + u (.) r_t c_t,   c_t = dO_t . v_t
//   dv_t = dS_t^T k_t + dO_t (r_t . (u (.) k_t)),   du = sum_{n,t} r_t (.) k_t c_t
//   dlw_t = Phi + sum_{m>t} r_m (.) dr^_m - sum_{m>=t} k_m (.) dk^_m,   dw_t = dlw_t (.) lw_t
//
// (dr^, dk^: dr and dk without their u terms; Phi = rowsum(S (.) dS) at the
// end of the 16-token sub-chunk holding t, the sums over its tokens; the
// identity follows from dlw_t = dec_t (.) rowsum(S_{t-1} (.) dS_t), so no
// per-token d x d product is formed).  r, k, v and dO fp32 or bf16, w, u and
// the states fp32; dr, dk, dv in r's type, dw, du and dstate0 fp32.
//
// Replaces no TPU kernel: the JAX package differentiates its chunked XLA form
// of the recurrence (models/ssm.py::rwkv6_chunked) with jax.grad, and its
// Pallas kernel (kernels/rwkv6_scan.py) has no backward.  Added so that a
// training step's RWKV-6 gradient runs on a hand-written kernel, as its
// forward does (kernels/rwkv6_scan.py's RWKV6Scan calls it).
//
// Bound on the H100: its bytes.  At rwkv6-7b's training call (r, k, v, dO
// [2, 64, 512, 64] bf16, w fp32) it must read r, k, v, dO and w and write dr,
// dk, dv and dw, 92.3 MB or 0.028 ms at 3.35 TB/s; its d^2 products are about
// 2.7 GFLOP, 0.016 ms in 3xTF32 on the tensor cores.  Three launches:
//
// 1. The forward's own state walk (rwkv6_chunk.cuh, SAVE = true) writes the
//    state at the start of every sub-chunk and the final state into a
//    scratch the wrapper allocates: n h (ceil(t / 16) + 1) d^2 fp32, 69 MB
//    at the training call (written once, read once: 0.041 ms of traffic).
//    Storing fewer states and recomputing between them is later work.
// 2. rwkv6_bwd_kernel walks each pair's sub-chunks from the last to the
//    first, a block per pair and tile of NT value columns (NT = d up to 64:
//    one block a pair, 128 at the training call; NT = 32 at d 65-128), with
//    dS^T [NT x d] resident in fp32 registers in the accumulator layout of
//    its update, as the forward holds S^T.  Per sub-chunk, with D_t and E_t
//    the decays from the sub-chunk's start to t and from t to its end, and
//    P_st the decay strictly between tokens s < t, each a product of the
//    per-token decays (every factor <= 1, no exponential beyond dec itself):
//
//      dv^T  = dS^T (k (.) E)^T + dO^T A        (A the forward's pairwise matrix, its diagonal the bonus)
//      X     = dO S0^T,   Y = v dS                (over the tile's columns)
//      dr^_t = D_t (.) X_t + sum_{s<t} B_ts k_s (.) P_st,   dk^_t = E_t (.) Y_t + sum_{m>t} B_mt r_m (.) P_tm
//      dS^T <- dS^T (.)cols D_16 + dO^T (r (.) D)
//
//    with S0 the stored state at the sub-chunk's start and B_ts = dO_t . v_s.
//    The four d^2 products run in 3xTF32 on mma.sync.m16n8k8 (hopper_mma.cuh),
//    each 8-deep chain in a fresh fragment added to its fp32 sum; a bf16 dO or
//    v is exact in TF32 and takes two products of three.  dv and the update
//    read the resident dS^T as the A operand (its column pair 2t, 2t+1 read
//    as k = t, t + 4, as the forward reads S^T); Y needs dS^T as a B operand,
//    so it is copied to shared memory each sub-chunk; S0 arrives by cp.async
//    a sub-chunk ahead, with r, k, v, w and dO.  A, B, the decay scans, the
//    pairwise sums of dr^ and dk^ (120 a key column each), the bonus terms and
//    the dw running sum run on the CUDA cores, each in a fixed order.  Phi at
//    a sub-chunk's end is rowsum(S0 (.) dS) of the sub-chunk after it, taken
//    as soon as the update has made that dS (the final state's for the last).
//    Tokens past t are padded with r = k = v = dO = 0 and dec = 1, which
//    leaves S and dS unchanged; key rows and value columns past d are zero.
// 3. A pass sums what the value-column tiles share, in tile order (dr, dk
//    and dlw, only where d > 64), and du over the sequences and tiles, in
//    order.  No atomics: two calls give the same bits.
//
// Every term of dr, dk, dlw and du is a sum over the value columns, so a
// tile's part is its columns' share and the parts add; dv and dstate0 belong
// to one tile's columns.  A pair's arithmetic does not depend on the other
// pairs: results are independent of the batch.

#include <type_traits>

#include "rwkv6_chunk.cuh"

namespace {

// block shape of the backward for a padded head dim DP: NT value columns a
// block, 16 a warp, and the keys split in two halves over two warps per 16
// columns (the forward's layout); DP = 128 takes NT = 32 so that its shared
// memory fits one block
template <int DP>
struct BTile {
  static constexpr int NT = DP <= 64 ? DP : 32;
  static constexpr int JW = NT / 16;           // warps along the value columns
  static constexpr int WARPS = 2 * JW;         // x 2 key halves
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NQ = DP / 16;           // 8-key slices of a key half
  static constexpr int NKW = DP / 8 / WARPS;   // 8-key tiles a warp takes of X and Y
};

template <typename T, int DP>
struct BSmem {
  static constexpr int NT = BTile<DP>::NT;
  T r[2][C * DP], k[2][C * DP];                 // staged rows [t * d + i]
  T v[2][C * NT], o[2][C * NT];                 // staged tile columns [t * NT + jj] (o: dO)
  float w[2][C * DP];
  float s0[2][DP][NT + 4];                      // the stored state at the sub-chunk's start
  float dss[NT][DP + 8];                        // dS^T at the sub-chunk's end
  float rf[C][DP], kf[C][DP], dec[C][DP];
  float vf[C][NT + 4], of[C][NT + 4];           // v, dO in fp32 (for B)
  uint32_t rdh[C][DP + 8], rdl[C][DP + 8];      // r (.) D, hi / lo
  uint32_t krh[C][DP + 8], krl[C][DP + 8];      // k (.) E
  uint32_t vh[C][NT + 8], vl[C][NT + 8];        // v, hi / lo
  uint32_t oh[C][NT + 8], ol[C][NT + 8];        // dO, hi / lo
  uint32_t ah[C][AS], al[C][AS];                // A [t][s], t >= s
  float bm[C][C + 1];                           // B [t][s] = dO_t . v_s over the tile, t >= s
  float x[C][DP + 4], y[C][DP + 4];             // X, Y; then dr^, dk^
  float ys[2][C][NT + 4];                       // dv, per key half
  float phi[2][BTile<DP>::JW][DP];              // Phi's parts, per column warp
  float dl[DP], us[DP];                         // D_16, u
};

template <typename T, int DP>
__global__ void __launch_bounds__(BTile<DP>::THREADS, 1)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const T* __restrict__ dout, const float* __restrict__ dsT,
                 const float* __restrict__ states, T* __restrict__ dr, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ dw, float* __restrict__ ds0,
                 float* __restrict__ parts, float* __restrict__ du_part, int NH, int H, int Tn,
                 int D, int vec) {
  using TL = BTile<DP>;
  constexpr int NT = TL::NT, JW = TL::JW, WARPS = TL::WARPS, THREADS = TL::THREADS;
  constexpr int NQ = TL::NQ, NKW = TL::NKW;
  constexpr int QG = NQ < 2 ? NQ : 2;           // slices a group of the dv product
  constexpr int CPL = DP >= 32 ? DP / 32 : 1;   // key columns a lane in A
  constexpr int CPV = NT >= 32 ? NT / 32 : 1;   // value columns a lane in B
  constexpr bool FP32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BSmem<T, DP>& sm = *reinterpret_cast<BSmem<T, DP>*>(smem_raw);

  const int tiles = (D + NT - 1) / NT;
  const int pair = blockIdx.x / tiles, tile = blockIdx.x % tiles, col0 = tile * NT;
  const int ncol = min(NT, D - col0);           // live columns of the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp % JW) * 16;          // the warp's first column in the tile
  const int hw = warp / JW;                 // its key half, keys [8 q0, 8 (q0 + NQ))
  const int q0 = hw * NQ;
  const int i0 = lane * CPL, ia = i0 < DP ? i0 : 0;   // A's key columns of this lane
  const int j0 = lane * CPV, ja = j0 < NT ? j0 : 0;   // B's value columns
  const size_t seq = (size_t)pair * Tn * D;
  const size_t sbase = (size_t)pair * D * D;
  const size_t count = (size_t)NH * Tn * D;
  const int nchunks = (Tn + C - 1) / C;
  const float* st = states + (size_t)pair * (nchunks + 1) * D * D;

  for (int i = tid; i < DP; i += THREADS)
    sm.us[i] = i < D ? u[(size_t)(pair % H) * D + i] : 0.f;
  for (int e = tid; e < C * AS; e += THREADS) {   // A's upper triangle stays 0
    sm.ah[e / AS][e % AS] = 0u;
    sm.al[e / AS][e % AS] = 0u;
  }

  // dS^T in the accumulator layout of its update: S[q][e] holds dS[i][j] at
  // i = 8 (q0 + q) + 2 t4 + (e & 1), j = col0 + m0 + g + 8 (e >> 1)
  float S[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * (q0 + q) + 2 * t4 + (e & 1), j = col0 + m0 + g + 8 * (e >> 1);
      S[q][e] = (dsT != nullptr && i < D && j < D) ? dsT[sbase + (size_t)i * D + j] : 0.f;
    }

  // this warp's part of Phi = rowsum(S (.) dS) over its 16 columns: the two
  // columns of a thread, then the 8 lanes g in halves (lane bits 4, 8, 16)
  auto phi_part = [&](float (*out)[DP], auto&& s_at) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int i = 8 * (q0 + q) + 2 * t4;
      float p0 = fmaf(s_at(i, m0 + g + 8), S[q][2], s_at(i, m0 + g) * S[q][0]);
      float p1 = fmaf(s_at(i + 1, m0 + g + 8), S[q][3], s_at(i + 1, m0 + g) * S[q][1]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      }
      if (g == 0) {
        out[warp % JW][i] = p0;
        out[warp % JW][i + 1] = p1;
      }
    }
  };
  {   // Phi at the last sub-chunk's end: the final state against dS_T
    const float* sT = st + (size_t)nchunks * D * D;
    phi_part(sm.phi[0], [&](int i, int jj) {
      return (i < D && jj < ncol) ? sT[(size_t)i * D + col0 + jj] : 0.f;
    });
  }

  // a sub-chunk's r, k, w rows, its v and dO tile columns and its stored
  // start state into buffer b: cp.async in 16-byte pieces where every row
  // starts 16-byte aligned (zero-filled past d), else plain loads
  auto stage = [&](int b, int c) {
    const int rows = min(C, Tn - c * C), n = rows * D;
    const size_t at = seq + (size_t)c * C * D;
    const float* sc = st + (size_t)c * D * D;
    if (vec) {
      constexpr int TE = 16 / sizeof(T);
      for (int p = tid * TE; p < n; p += THREADS * TE) {
        tc::cp_async16(&sm.r[b][p], r + at + p, true);
        tc::cp_async16(&sm.k[b][p], k + at + p, true);
      }
      for (int p = tid * 4; p < n; p += THREADS * 4) tc::cp_async16(&sm.w[b][p], w + at + p, true);
      for (int p = tid * TE; p < rows * NT; p += THREADS * TE) {
        const int t = p / NT, jj = p % NT;
        const bool ok = jj < ncol;
        const size_t src = at + (size_t)t * D + col0 + (ok ? jj : 0);
        tc::cp_async16(&sm.v[b][p], v + src, ok);
        tc::cp_async16(&sm.o[b][p], dout + src, ok);
      }
      for (int p = tid * 4; p < DP * NT; p += THREADS * 4) {
        const int i = p / NT, jj = p % NT;
        const bool ok = i < D && jj < ncol;
        tc::cp_async16(&sm.s0[b][i][jj], sc + (ok ? (size_t)i * D + col0 + jj : 0), ok);
      }
    } else {
      for (int e = tid; e < n; e += THREADS) {
        sm.r[b][e] = r[at + e];
        sm.k[b][e] = k[at + e];
        sm.w[b][e] = w[at + e];
      }
      for (int e = tid; e < rows * NT; e += THREADS) {
        const int t = e / NT, jj = e % NT;
        if (jj < ncol) {
          sm.v[b][e] = v[at + (size_t)t * D + col0 + jj];
          sm.o[b][e] = dout[at + (size_t)t * D + col0 + jj];
        }
      }
      for (int e = tid; e < DP * NT; e += THREADS) {
        const int i = e / NT, jj = e % NT;
        sm.s0[b][i][jj] = (i < D && jj < ncol) ? sc[(size_t)i * D + col0 + jj] : 0.f;
      }
    }
  };

  float du_acc = 0.f;   // thread i < DP: du's part of key i, in the walk's order
  stage(0, nchunks - 1);
  tc::cp_async_commit();
  for (int it = 0; it < nchunks; ++it) {
    const int c = nchunks - 1 - it, b = it & 1, t0 = c * C, rows = min(C, Tn - t0);
    tc::cp_async_wait<0>();
    __syncthreads();   // this sub-chunk is staged; every thread is done with the last one
    if (c > 0) stage(b ^ 1, c - 1);
    tc::cp_async_commit();

    // decays, and r, k, v, dO in fp32 and split (padded tokens and columns: 0, dec 1)
    for (int e = tid; e < C * DP; e += THREADS) {
      const int t = e / DP, i = e % DP, at = t * D + i;
      const bool ok = t < rows && i < D;
      sm.rf[t][i] = ok ? to_f(sm.r[b][at]) : 0.f;
      sm.kf[t][i] = ok ? to_f(sm.k[b][at]) : 0.f;
      sm.dec[t][i] = ok ? expf(-expf(sm.w[b][at])) : 1.f;
    }
    for (int e = tid; e < C * NT; e += THREADS) {
      const int t = e / NT, jj = e % NT;
      const bool ok = t < rows && jj < ncol;
      const float xv = ok ? to_f(sm.v[b][e]) : 0.f, xo = ok ? to_f(sm.o[b][e]) : 0.f;
      sm.vf[t][jj] = xv;
      sm.of[t][jj] = xo;
      if constexpr (FP32) {
        const Split sv = split_tf32(xv), so = split_tf32(xo);
        sm.vh[t][jj] = sv.hi;
        sm.vl[t][jj] = sv.lo;
        sm.oh[t][jj] = so.hi;
        sm.ol[t][jj] = so.lo;
      } else {
        sm.vh[t][jj] = __float_as_uint(xv);   // bf16 is exact in TF32
        sm.oh[t][jj] = __float_as_uint(xo);
      }
    }
    __syncthreads();

    // the two decay scans, one key column each: r_t (.) D_t and D_16, and
    // k_s (.) E_s, as the forward forms them
    for (int it2 = tid; it2 < 2 * DP; it2 += THREADS) {
      float x = 1.f;
      if (it2 < DP) {
        const int i = it2;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          const Split s = split_tf32(sm.rf[t][i] * x);
          sm.rdh[t][i] = s.hi;
          sm.rdl[t][i] = s.lo;
          x *= sm.dec[t][i];
        }
        sm.dl[i] = x;
      } else {
        const int i = it2 - DP;
#pragma unroll
        for (int t = C - 1; t >= 0; --t) {
          const Split s = split_tf32(sm.kf[t][i] * x);
          sm.krh[t][i] = s.hi;
          sm.krl[t][i] = s.lo;
          x *= sm.dec[t][i];
        }
      }
    }
    // A and B below the diagonal, pair by pair, as the forward walks A: warp
    // turn p takes rows s = p and 15 - p, 15 pairs (t, s) in 16 slots; each
    // lane sums CPL key columns of A (the decay from s to t a running
    // product) and CPV value columns of B; then the slots are summed over
    // the lanes in a fixed order
#pragma unroll
    for (int pw = 0; pw < C / 2 / WARPS; ++pw) {
      const int p = warp + pw * WARPS;
      const int split = C - 1 - p;          // slots [0, split): row p, t = p + 1 + slot
      float kp[CPL], k2[CPL], vp[CPV], v2[CPV], acc[16], bcc[16];
      lds(kp, &sm.kf[p][ia]);
      lds(k2, &sm.kf[C - 1 - p][ia]);
      lds(vp, &sm.vf[p][ja]);
      lds(v2, &sm.vf[C - 1 - p][ja]);
#pragma unroll
      for (int sl = 0; sl < C - 1; ++sl) {
        const int t = sl < split ? p + 1 + sl : sl + 1;
#pragma unroll
        for (int c8 = 0; c8 < CPL; ++c8) kp[c8] = sl == split ? k2[c8] : kp[c8];
#pragma unroll
        for (int c8 = 0; c8 < CPV; ++c8) vp[c8] = sl == split ? v2[c8] : vp[c8];
        float rr[CPL], dd[CPL], oo[CPV], a = 0.f, bb = 0.f;
        lds(rr, &sm.rf[t][ia]);
        lds(dd, &sm.dec[t][ia]);
        lds(oo, &sm.of[t][ja]);
#pragma unroll
        for (int c8 = 0; c8 < CPL; ++c8) {
          a = fmaf(rr[c8], kp[c8], a);
          kp[c8] *= dd[c8];
        }
#pragma unroll
        for (int c8 = 0; c8 < CPV; ++c8) bb = fmaf(oo[c8], vp[c8], bb);
        acc[sl] = i0 < DP ? a : 0.f;
        bcc[sl] = j0 < NT ? bb : 0.f;
      }
      acc[C - 1] = 0.f;
      bcc[C - 1] = 0.f;
      const float suma = reduce_scatter16(acc, lane);
      const float sumb = reduce_scatter16(bcc, lane);
      const int sl = lane >> 1;
      if ((lane & 1) == 0 && sl < C - 1) {
        const int t = sl < split ? p + 1 + sl : sl + 1, s = sl < split ? p : C - 1 - p;
        const Split sp = split_tf32(suma);
        sm.ah[t][s] = sp.hi;
        sm.al[t][s] = sp.lo;
        sm.bm[t][s] = sumb;
      }
    }
    // the diagonals: A_tt = sum_i r_ti u_i k_ti (the bonus) and c_t = B_tt =
    // dO_t . v_t, tokens warp + n WARPS, each summed over the lanes in a
    // fixed order
    {
      constexpr int BT = C / WARPS;
      float a[BT], bb[BT];
#pragma unroll
      for (int n = 0; n < BT; ++n) {
        const int t = warp + n * WARPS;
        float rr[CPL], kk[CPL], uu[CPL], oo[CPV], vv[CPV];
        lds(rr, &sm.rf[t][ia]);
        lds(kk, &sm.kf[t][ia]);
        lds(uu, &sm.us[ia]);
        lds(oo, &sm.of[t][ja]);
        lds(vv, &sm.vf[t][ja]);
        a[n] = 0.f;
        bb[n] = 0.f;
#pragma unroll
        for (int c8 = 0; c8 < CPL; ++c8) a[n] = fmaf(rr[c8] * uu[c8], kk[c8], a[n]);
#pragma unroll
        for (int c8 = 0; c8 < CPV; ++c8) bb[n] = fmaf(oo[c8], vv[c8], bb[n]);
        a[n] = i0 < DP ? a[n] : 0.f;
        bb[n] = j0 < NT ? bb[n] : 0.f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int n = 0; n < BT; ++n) {
          a[n] += __shfl_xor_sync(0xffffffffu, a[n], o);
          bb[n] += __shfl_xor_sync(0xffffffffu, bb[n], o);
        }
      if (lane == 0) {
#pragma unroll
        for (int n = 0; n < BT; ++n) {
          const int t = warp + n * WARPS;
          const Split sp = split_tf32(a[n]);
          sm.ah[t][t] = sp.hi;
          sm.al[t][t] = sp.lo;
          sm.bm[t][t] = bb[n];
        }
      }
    }
    // dS^T at the sub-chunk's end, for Y's B operand
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm.dss[m0 + g + 8 * (e >> 1)][8 * (q0 + q) + 2 * t4 + (e & 1)] = S[q][e];
    __syncthreads();

    // X = dO S0^T and Y = v dS over the tile's columns, [16 tokens x 8 keys]
    // tiles warp NKW + kk, one fresh fragment per 8 columns
    {
      float xa[NKW][4] = {}, ya[NKW][4] = {};
#pragma unroll
      for (int ks = 0; ks < NT / 8; ++ks) {
        const int kc = 8 * ks + t4;
        uint32_t oa[4], oal[4], va[4], val[4];
        oa[0] = sm.oh[g][kc];
        oa[1] = sm.oh[g + 8][kc];
        oa[2] = sm.oh[g][kc + 4];
        oa[3] = sm.oh[g + 8][kc + 4];
        va[0] = sm.vh[g][kc];
        va[1] = sm.vh[g + 8][kc];
        va[2] = sm.vh[g][kc + 4];
        va[3] = sm.vh[g + 8][kc + 4];
        if constexpr (FP32) {
          oal[0] = sm.ol[g][kc];
          oal[1] = sm.ol[g + 8][kc];
          oal[2] = sm.ol[g][kc + 4];
          oal[3] = sm.ol[g + 8][kc + 4];
          val[0] = sm.vl[g][kc];
          val[1] = sm.vl[g + 8][kc];
          val[2] = sm.vl[g][kc + 4];
          val[3] = sm.vl[g + 8][kc + 4];
        }
        uint32_t sh[NKW][2], sl[NKW][2], dh[NKW][2], dlo[NKW][2];
#pragma unroll
        for (int kk = 0; kk < NKW; ++kk) {
          const int n = 8 * (warp * NKW + kk) + g;
          const Split a0 = split_tf32(sm.s0[b][n][kc]), a1 = split_tf32(sm.s0[b][n][kc + 4]);
          const Split d0 = split_tf32(sm.dss[kc][n]), d1 = split_tf32(sm.dss[kc + 4][n]);
          sh[kk][0] = a0.hi;
          sh[kk][1] = a1.hi;
          sl[kk][0] = a0.lo;
          sl[kk][1] = a1.lo;
          dh[kk][0] = d0.hi;
          dh[kk][1] = d1.hi;
          dlo[kk][0] = d0.lo;
          dlo[kk][1] = d1.lo;
        }
        if constexpr (FP32) {
          tc::mma_3xtf32<NKW>(xa, oa, oal, sh, sl);
          tc::mma_3xtf32<NKW>(ya, va, val, dh, dlo);
        } else {
          mma_exact_a<NKW>(xa, oa, sh, sl);
          mma_exact_a<NKW>(ya, va, dh, dlo);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NKW; ++kk) {
        const int n = 8 * (warp * NKW + kk) + 2 * t4;
        sm.x[g][n] = xa[kk][0];
        sm.x[g][n + 1] = xa[kk][1];
        sm.x[g + 8][n] = xa[kk][2];
        sm.x[g + 8][n + 1] = xa[kk][3];
        sm.y[g][n] = ya[kk][0];
        sm.y[g][n + 1] = ya[kk][1];
        sm.y[g + 8][n] = ya[kk][2];
        sm.y[g + 8][n + 1] = ya[kk][3];
      }
    }

    // dO^T fragments (A operand of dv's intra term and of the update), 8
    // tokens a step
    uint32_t oah[2][4], oal[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int s = 8 * ks + t4;
      oah[ks][0] = sm.oh[s][m0 + g];
      oah[ks][1] = sm.oh[s][m0 + g + 8];
      oah[ks][2] = sm.oh[s + 4][m0 + g];
      oah[ks][3] = sm.oh[s + 4][m0 + g + 8];
      if constexpr (FP32) {
        oal[ks][0] = sm.ol[s][m0 + g];
        oal[ks][1] = sm.ol[s][m0 + g + 8];
        oal[ks][2] = sm.ol[s + 4][m0 + g];
        oal[ks][3] = sm.ol[s + 4][m0 + g + 8];
      }
    }
    // dv^T [16 columns x 16 tokens]: this key half's part of dS^T (k (.) E)^T,
    // 8 keys a slice, QG slices' products issued side by side (the forward's
    // inter product), then dO^T A over this half's 8 tokens m
    {
      float y[2][4] = {};
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
            const uint2 h = *reinterpret_cast<const uint2*>(&sm.krh[8 * nt + g][kq]);
            const uint2 l = *reinterpret_cast<const uint2*>(&sm.krl[8 * nt + g][kq]);
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
      uint32_t bhi[2][2], blo[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        bhi[nt][0] = sm.ah[8 * hw + t4][8 * nt + g];
        bhi[nt][1] = sm.ah[8 * hw + t4 + 4][8 * nt + g];
        blo[nt][0] = sm.al[8 * hw + t4][8 * nt + g];
        blo[nt][1] = sm.al[8 * hw + t4 + 4][8 * nt + g];
      }
      uint32_t a[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = hw ? oah[1][e] : oah[0][e];
        alo[e] = FP32 ? (hw ? oal[1][e] : oal[0][e]) : 0u;
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
    }

    // the update: dS^T <- dS^T (.)cols D_16 + dO^T (r (.) D), one fresh
    // fragment per 8 keys over the 16 tokens, added with one rounding (the
    // forward's state product)
    {
      float d[NQ][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bhi[NQ][2], blo[NQ][2];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int i = 8 * (q0 + q) + g;
          bhi[q][0] = sm.rdh[8 * ks + t4][i];
          bhi[q][1] = sm.rdh[8 * ks + t4 + 4][i];
          blo[q][0] = sm.rdl[8 * ks + t4][i];
          blo[q][1] = sm.rdl[8 * ks + t4 + 4][i];
        }
        if constexpr (FP32) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (ks == 0)
              tc::mma_tf32_zero(d[q], oal[ks], bhi[q]);
            else
              tc::mma_tf32(d[q], oal[ks], bhi[q]);
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q) tc::mma_tf32(d[q], oah[ks], blo[q]);
        } else {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (ks == 0)
              tc::mma_tf32_zero(d[q], oah[ks], blo[q]);
            else
              tc::mma_tf32(d[q], oah[ks], blo[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) tc::mma_tf32(d[q], oah[ks], bhi[q]);
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
    // Phi at the end of the sub-chunk before: this sub-chunk's start state
    // against the dS just made
    if (c > 0) phi_part(sm.phi[b ^ 1], [&](int i, int jj) { return sm.s0[b][i][jj]; });
    __syncthreads();

    // dr^ and dk^: the inter terms decayed, plus the pairs inside the
    // sub-chunk, one key column each (dr^ summed over s ascending, dk^ over
    // m descending, each pair's decay a running product)
    for (int it2 = tid; it2 < 2 * DP; it2 += THREADS) {
      float acc[C];
#pragma unroll
      for (int t = 0; t < C; ++t) acc[t] = 0.f;
      if (it2 < DP) {
        const int i = it2;
#pragma unroll
        for (int s = 0; s < C - 1; ++s) {
          float kp = sm.kf[s][i];
#pragma unroll
          for (int t = s + 1; t < C; ++t) {
            acc[t] = fmaf(sm.bm[t][s], kp, acc[t]);
            kp *= sm.dec[t][i];
          }
        }
        float x = 1.f;
#pragma unroll
        for (int t = 0; t < C; ++t) {
          sm.x[t][i] = fmaf(x, sm.x[t][i], acc[t]);
          x *= sm.dec[t][i];
        }
      } else {
        const int i = it2 - DP;
#pragma unroll
        for (int m = C - 1; m > 0; --m) {
          float rp = sm.rf[m][i];
#pragma unroll
          for (int t = m - 1; t >= 0; --t) {
            acc[t] = fmaf(sm.bm[m][t], rp, acc[t]);
            rp *= sm.dec[t][i];
          }
        }
        float x = 1.f;
#pragma unroll
        for (int t = C - 1; t >= 0; --t) {
          sm.y[t][i] = fmaf(x, sm.y[t][i], acc[t]);
          x *= sm.dec[t][i];
        }
      }
    }
    // dv: the two key halves' parts added in order, four columns of one
    // token a thread
    {
      const int tok = tid / (NT / 4), jj = 4 * (tid % (NT / 4)), j = col0 + jj;
      if (tok < rows) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.ys[0][tok][jj]);
        const float4 bq = *reinterpret_cast<const float4*>(&sm.ys[1][tok][jj]);
        const float4 yv = make_float4(a.x + bq.x, a.y + bq.y, a.z + bq.z, a.w + bq.w);
        T* o = dv + seq + (size_t)(t0 + tok) * D + j;
        if (vec) {
          if (j < D) store4(o, yv);
        } else {
          const float yy[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            if (j + cc < D) attn::store1(o + cc, yy[cc]);
        }
      }
    }
    __syncthreads();

    // per key column: the u terms, du, and dlw from Phi back over the
    // sub-chunk's tokens; written out (dw = dlw (.) lw), or as this tile's
    // fp32 parts where the columns take several tiles
    if (tid < DP) {
      const int i = tid;
      float xr = 0.f;
#pragma unroll
      for (int wq = 0; wq < JW; ++wq) xr += sm.phi[b][wq][i];
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        const float cc = sm.bm[t][t], rr = sm.rf[t][i], kk = sm.kf[t][i];
        const float drh = sm.x[t][i], dkh = sm.y[t][i];
        xr = fmaf(-kk, dkh, xr);
        const float dlw = xr;
        xr = fmaf(rr, drh, xr);
        const float drt = fmaf(sm.us[i] * kk, cc, drh);
        const float dkt = fmaf(sm.us[i] * rr, cc, dkh);
        du_acc = fmaf(rr * kk, cc, du_acc);
        if (t < rows && i < D) {
          const size_t at = seq + (size_t)(t0 + t) * D + i;
          if (tiles == 1) {
            attn::store1(dr + at, drt);
            attn::store1(dk + at, dkt);
            dw[at] = dlw * -expf(sm.w[b][t * D + i]);
          } else {
            parts[(size_t)tile * count + at] = drt;
            parts[(size_t)(tiles + tile) * count + at] = dkt;
            parts[(size_t)(2 * tiles + tile) * count + at] = dlw;
          }
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * (q0 + q) + 2 * t4 + (e & 1), j = col0 + m0 + g + 8 * (e >> 1);
      if (ds0 != nullptr && i < D && j < D) ds0[sbase + (size_t)i * D + j] = S[q][e];
    }
  if (tid < D) du_part[((size_t)pair * tiles + tile) * D + tid] = du_acc;
}

// dr, dk and dw from the value-column tiles' parts, summed in tile order
template <typename T>
__global__ void rwkv6_bwd_sum_tiles(const float* __restrict__ parts, const float* __restrict__ w,
                                    T* __restrict__ dr, T* __restrict__ dk,
                                    float* __restrict__ dw, size_t count, int tiles) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int tl = 0; tl < tiles; ++tl) {
    a += parts[(size_t)tl * count + e];
    b += parts[(size_t)(tiles + tl) * count + e];
    c += parts[(size_t)(2 * tiles + tl) * count + e];
  }
  attn::store1(dr + e, a);
  attn::store1(dk + e, b);
  dw[e] = c * -expf(w[e]);
}

// du [H, D]: the blocks' parts summed over the sequences, then the tiles,
// in order
__global__ void rwkv6_bwd_du(const float* __restrict__ du_part, float* __restrict__ du, int N,
                             int H, int D, int tiles) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * D) return;
  const int h = e / D, i = e % D;
  float s = 0.f;
  for (int n = 0; n < N; ++n)
    for (int tl = 0; tl < tiles; ++tl) s += du_part[((size_t)(n * H + h) * tiles + tl) * D + i];
  du[e] = s;
}

template <typename T, int DP>
int launch_bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
               const float* s0, const void* dout, const float* dsT, void* dr, void* dk, void* dv,
               float* dw, float* du, float* ds0, float* states, float* parts, float* du_part,
               int N, int H, int Tn, int D, cudaStream_t stream) {
  using TL = BTile<DP>;
  const int NH = N * H, tiles = (D + TL::NT - 1) / TL::NT;
  int err = launch_chunk<T, DP, true>(r, k, v, w, u, s0, nullptr, states, NH, H, Tn, D, stream);
  if (err != 0) return err;
  const int smem = (int)sizeof(BSmem<T, DP>);
  auto kern = rwkv6_bwd_kernel<T, DP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 8 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
                  aligned16(dout) && aligned16(states) && aligned16(dv);
  kern<<<NH * tiles, TL::THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      static_cast<const T*>(dout), dsT, states, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dw, ds0, parts, du_part, NH, H, Tn, D, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (tiles > 1) {
    const size_t count = (size_t)NH * Tn * D;
    rwkv6_bwd_sum_tiles<T><<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
        parts, w, static_cast<T*>(dr), static_cast<T*>(dk), dw, count, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rwkv6_bwd_du<<<(H * D + 255) / 256, 256, 0, stream>>>(du_part, du, N, H, D, tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
                 const float* s0, const void* dout, const float* dsT, void* dr, void* dk,
                 void* dv, float* dw, float* du, float* ds0, float* states, float* parts,
                 float* du_part, int N, int H, int Tn, int D, cudaStream_t stream) {
#define RWKV_BWD(DP)                                                                          \
  return launch_bwd<T, DP>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, states, parts, \
                           du_part, N, H, Tn, D, stream)
  if (D <= 16) RWKV_BWD(16);
  if (D <= 32) RWKV_BWD(32);
  if (D <= 64) RWKV_BWD(64);
  RWKV_BWD(128);
#undef RWKV_BWD
}

}  // namespace

// r, k, v, dout [N, H, Tn, D] of one type (dtype 0 = fp32, 1 = bf16), w the
// same shape fp32, u [H, D] fp32, s0 [N, H, D, D] fp32 or null (zeros), dsT
// [N, H, D, D] fp32 or null (a zero cotangent); dr, dk, dv in r's type, dw
// like w, du [H, D], ds0 [N, H, D, D] or null (not wanted), all contiguous.
// Scratch: states [N H (ceil(Tn / 16) + 1) D D], parts [3 tiles N H Tn D]
// (tiles = ceil(D / 32) above D 64, else 1, and then parts may be null),
// du_part [N H tiles D], all fp32.  1 <= D <= 128.
extern "C" int rwkv6_scan_bwd_launch(const void* r, const void* k, const void* v,
                                     const float* w, const float* u, const float* s0,
                                     const void* dout, const float* dsT, void* dr, void* dk,
                                     void* dv, float* dw, float* du, float* ds0, float* states,
                                     float* parts, float* du_part, int N, int H, int Tn, int D,
                                     int dtype, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || Tn <= 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_bwd<float>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0, states,
                               parts, du_part, N, H, Tn, D, stream);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du, ds0,
                                       states, parts, du_part, N, H, Tn, D, stream);
  return (int)cudaErrorInvalidValue;
}
