// Online-softmax attention on the H100's tensor cores: out = softmax(q k^T *
// scale + mask) v with no [Sq, Skv] matrix in device memory.  fp32 or bf16
// inputs, fp32 softmax statistics and accumulation, output rounded to
// nearest-even in the input type.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel) in full: the VAE mid-block's single head over the H*W tokens
// of the latent grid (non-causal, d = 512, fp32) and the LM prefill's
// attention (causal, optional sliding window, grouped-query heads, d = 128;
// zamba2's shared block at d = 80; bf16).  Positions align at the sequence
// end: query row i sits at i + Skv - Sq; the mask keeps k <= q (causal) and
// k > q - window.  A q head bh reads kv head (bh / Hq) * Hkv + (bh % Hq) /
// (Hq / Hkv), as the Pallas kernel's index map does, with no repeated k/v in
// memory.  A row with no key left (only possible with Sq > Skv) gives 0.
//
// Bound on the H100: operations.  Each query row does 2 * Skv * d MACs for
// q k^T and as many for p v against O(d) bytes; the card's peaks are 67
// TFLOP/s in fp32 on the CUDA cores, 495 TFLOP/s in TF32 and 989 TFLOP/s in
// bf16 on the tensor cores.  Both paths run on the tensor cores:
//
// bf16 (the LM prefill): a block of three warpgroups owns 192 queries, each
// warpgroup 64 of them, with its rows of Q held in registers.  S = Q K^T is
// wgmma.m64n64k16 with Q from registers and the K tile from shared memory;
// P is rescaled in registers, rounded to bf16 and fed back from registers
// as the A operand of O += P V (the accumulator fragment of S is the A
// fragment of P), with V read from shared memory through the descriptor's
// transpose (MN-major), so neither P nor a transposed V is ever written.
// K/V tiles of 64 keys, shared by the warpgroups, arrive by cp.async into a
// ring of two stages, so the next tile's copy overlaps this tile's
// products.  The head dim is padded with zeros to the MMA depth (16).
// Above d = 128, which no model uses, bf16 runs through the fp32 kernel
// below: its loads widen bf16 exactly and its output rounds to bf16, and
// 3xTF32 with an fp32 P is the more accurate of the two paths.
//
// fp32 (the VAE, and fp32 LMs): 3xTF32 on mma.sync.m16n8k8, 16 query rows
// per warp, 4 or 8 warps per block (8 share each K/V slice among 128 rows,
// where the grid still fills the card twice over and no window applies).
// Every operand is split once, as it is staged in shared memory, into tf32
// hi and lo planes; a product sums lo*hi + hi*lo + hi*hi (lo*lo dropped),
// which keeps fp32-grade products (about 2^-22 relative) at up to 165
// TFLOP/s, where one TF32 pass keeps 2^-11.  q and k are streamed in
// 32-wide slices of d, v in 128-column slices of the output; P stays fp32
// and is split in registers, its accumulator fragment reused as the A
// fragment of P V by ordering each 8-key step's keys (2t, 2t+1) -> (t,
// t+4) on both operands.  Each 32-wide slice of q k^T and each tile's P V
// is summed in a fresh fragment, then added on the CUDA cores with
// round-to-nearest (the tensor core's own accumulation drifts; see
// hopper_mma.cuh), the rescale of O folded into that add.
//
// Both paths: the longest causal rows first, so the short ones fill the
// tail; the kv loop is bounded by the causal diagonal and the window, and
// only tiles that cross the diagonal, the window's edge or Skv are masked.
// Every row is reduced in a fixed order by the same threads, so the result
// does not depend on how many images or sequences share the launch.

#include "attn_common.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int BKV = 64;                 // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Geo {
  int q0, d0, kv_lo, kv_hi, off;
  // whether the `rows` rows from qlo need the mask on the tile at kv0
  __device__ bool masked(int kv0, int qlo, int rows, int Skv, int causal, int window) const {
    return kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > qlo + off) ||
           (window > 0 && kv0 <= qlo + rows - 1 + off - window);
  }
};

// the block's rows [q0, q0 + bq), output columns from d0, and the keys any
// of its rows may see
__device__ __forceinline__ Geo geometry(int Sq, int Skv, int bq, int dv, int causal, int window) {
  Geo g;
  // the longest causal rows first, so the short ones fill the tail
  g.q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  g.d0 = blockIdx.y * dv;
  g.off = Skv - Sq;
  g.kv_lo = 0;
  g.kv_hi = Skv;
  if (causal) g.kv_hi = min(Skv, min(g.q0 + bq, Sq) + g.off);
  if (window > 0) g.kv_lo = max(0, g.q0 + g.off - window + 1) / BKV * BKV;
  return g;
}

// Online softmax over one 64-key tile for the two rows (qpos, qpos + 8) a
// thread holds: s[4c..4c+3] = (r, 8c+2t), (r, 8c+2t+1), (r+8, 8c+2t),
// (r+8, 8c+2t+1).  Leaves p in s; returns the two rescale factors.
__device__ __forceinline__ float2 softmax_tile(float* s, float* m, float* l, int qpos, int kv0,
                                               int t, bool mask, int Skv, int causal, int window,
                                               float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float v = s[4 * c + e] * scale2;
      if (mask) {
        const int kp = kv0 + 8 * c + 2 * t + (e & 1), qp = qpos + 8 * h;
        const bool keep = kp < Skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        v = keep ? v : -INFINITY;
      }
      s[4 * c + e] = v;
      mx[h] = fmaxf(mx[h], v);
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    // no key kept yet: exponentiate against 0, so every p is 2^-inf = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = ex2(m[h] - m_use);
    m[h] = m_new;
    mx[h] = m_use;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[4 * c + e] - mx[e >> 1]);
      s[4 * c + e] = p;
      rs[e >> 1] += p;
    }
  // partial row sums: the four lanes of a row are added at the very end
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
  return make_float2(corr[0], corr[1]);
}

// Normalise and store a thread's two rows of one 8-column chunk.
template <typename T>
__device__ __forceinline__ void store_pair(T* orow, int col, float a, float b);

template <>
__device__ __forceinline__ void store_pair<float>(float* p, int col, float a, float b) {
  *reinterpret_cast<float2*>(p + col) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, int col, float a,
                                                          float b) {
  *reinterpret_cast<uint32_t*>(p + col) = attn::pack_bf16x2(a, b);
}

template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* o, const float* acc, float* l, size_t row_base,
                                           int q0, int r0, int Sq, int D, int d0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= Sq) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    T* orow = o + (row_base + row) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = d0 + 8 * c + 2 * t;   // D % 4 == 0: the pair is in range
      if (col < D) store_pair<T>(orow, col, acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
    }
  }
}

// ===========================================================================
// bf16: wgmma
// ===========================================================================

// A block is three consumer warpgroups of 64 rows each; each keeps its Q
// rows in registers as the A operand of S = Q K^T, and all three share
// each K/V tile.
constexpr int BF16_NWG = 3, BF16_THREADS = 128 * BF16_NWG, BF16_BQ = 64 * BF16_NWG;

// Shared memory of one block, bytes: two stages of K [64 x DP] and of V
// [64 x DP], DP the head dim padded to 16, as no-swizzle core matrices
// (hopper_mma.cuh).  K is K-major: element (r, k) at (r/8)*DP*16 +
// (k/8)*128 + (r%8)*16 + (k%8)*2.  V is MN-major: element (kv, n) at
// (kv/8)*DP*16 + (n/8)*128 + (kv%8)*16 + (n%8)*2.
constexpr int bf16_smem(int dp) { return 2 * 2 * BKV * dp * 2; }

__device__ __forceinline__ int kmajor_off(int r, int k, int dqk) {
  return (r >> 3) * dqk * 16 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ int mnmajor_off(int kv, int n, int dv) {
  return (kv >> 3) * dv * 16 + (n >> 3) * 128 + (kv & 7) * 16 + (n & 7) * 2;
}

// rows x dqk of a [nrows, D] bf16 matrix (from row0) into K-major core
// matrices by NT threads; rows >= nrows and columns >= D are zeros.
// 16-byte copies when D % 8 == 0, else 8-byte ones (D % 4 == 0).
template <int NT>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, const __nv_bfloat16* src,
                                             int rows, int row0, int nrows, int D, int dqk) {
  if ((D & 7) == 0) {
    const int per_row = dqk / 8;
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, k = (e % per_row) * 8;
      const bool ok = row0 + r < nrows && k < D;
      tc::cp_async16(dst + kmajor_off(r, k, dqk), ok ? src + (size_t)(row0 + r) * D + k : src, ok);
    }
  } else {
    const int per_row = dqk / 4;
    for (int e = threadIdx.x; e < rows * per_row; e += NT) {
      const int r = e / per_row, k = (e % per_row) * 4;
      const bool ok = row0 + r < nrows && k < D;
      tc::cp_async8(dst + kmajor_off(r, k, dqk), ok ? src + (size_t)(row0 + r) * D + k : src, ok);
    }
  }
}

// 64 keys x DV columns (from d0) of v into MN-major core matrices
template <int NT, int DV>
__device__ __forceinline__ void stage_v(unsigned char* dst, const __nv_bfloat16* src, int row0,
                                        int nrows, int D, int d0) {
  if ((D & 7) == 0) {
    constexpr int per_row = DV / 8;
    for (int e = threadIdx.x; e < BKV * per_row; e += NT) {
      const int r = e / per_row, n = (e % per_row) * 8;
      const bool ok = row0 + r < nrows && d0 + n < D;
      tc::cp_async16(dst + mnmajor_off(r, n, DV), ok ? src + (size_t)(row0 + r) * D + d0 + n : src,
                     ok);
    }
  } else {
    constexpr int per_row = DV / 4;
    for (int e = threadIdx.x; e < BKV * per_row; e += NT) {
      const int r = e / per_row, n = (e % per_row) * 4;
      const bool ok = row0 + r < nrows && d0 + n < D;
      tc::cp_async8(dst + mnmajor_off(r, n, DV), ok ? src + (size_t)(row0 + r) * D + d0 + n : src,
                    ok);
    }
  }
}

// two bf16 of row `row`, columns col and col + 1, as one 32-bit word (0
// outside the matrix; D is even)
__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* m, int row, int nrows, int col,
                                            int D) {
  return row < nrows && col < D ? *reinterpret_cast<const uint32_t*>(m + (size_t)row * D + col) : 0u;
}

// DP: the head dim padded to the MMA depth (16), both the depth of q k^T
// and the width of the output
template <int DP>
__global__ void __launch_bounds__(BF16_THREADS, 1)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq,
               int Hkv, int Sq, int Skv, int D, float scale, int causal, int window) {
  constexpr int NT = BF16_THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const Ks = smem;                      // stage st at st * BKV * DP * 2
  unsigned char* const Vs = Ks + 2 * BKV * DP * 2;    // stage st at st * BKV * DP * 2

  const int bh = blockIdx.z;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const Geo geo = geometry(Sq, Skv, BF16_BQ, DP, causal, window);
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qlo = geo.q0 + 64 * wg;          // this warpgroup's first row
  const int r0 = 64 * wg + 16 * w + g;       // the thread's rows r0, r0 + 8 of the block
  const __nv_bfloat16* Q = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* K = k + (size_t)kvh * Skv * D;
  const __nv_bfloat16* V = v + (size_t)kvh * Skv * D;
  const float scale2 = scale * LOG2E;
  const int ntiles = geo.kv_hi > geo.kv_lo ? (geo.kv_hi - geo.kv_lo + BKV - 1) / BKV : 0;

  constexpr int NC = DP / 8;                 // 8-column chunks of the output
  float acc[4 * NC], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // Q as the A fragments of the warpgroup's 64 rows, one per 16-deep step
  constexpr int KS = DP / 16;
  uint32_t qa[4 * KS];
  {
    const int ra = geo.q0 + r0, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c0 = 16 * ks + 2 * t;
      qa[4 * ks] = pair_at(Q, ra, Sq, c0, D);
      qa[4 * ks + 1] = pair_at(Q, rb, Sq, c0, D);
      qa[4 * ks + 2] = pair_at(Q, ra, Sq, c0 + 8, D);
      qa[4 * ks + 3] = pair_at(Q, rb, Sq, c0 + 8, D);
    }
  }
  // geo.d0 is 0 here (one output slice); a literal 0 in its place leads
  // ptxas to spill a register in the d = 128 kernel, which runs slower
  if (ntiles > 0) {
    stage_kmajor<NT>(Ks, K, BKV, geo.kv_lo, Skv, D, DP);
    stage_v<NT, DP>(Vs, V, geo.kv_lo, Skv, D, geo.d0);
    tc::cp_async_commit();
  }

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, kv0 = geo.kv_lo + it * BKV;
    const unsigned char* const Kt = Ks + st * BKV * DP * 2;
    const unsigned char* const Vt = Vs + st * BKV * DP * 2;
    tc::cp_async_wait<0>();                  // this thread's copies of tile it
    tc::fence_proxy_async();
    __syncthreads();                         // everyone's; and tile it-1 is done
    if (it + 1 < ntiles) {                   // the next tile's copy overlaps this tile
      stage_kmajor<NT>(Ks + (st ^ 1) * BKV * DP * 2, K, BKV, kv0 + BKV, Skv, D, DP);
      stage_v<NT, DP>(Vs + (st ^ 1) * BKV * DP * 2, V, kv0 + BKV, Skv, D, geo.d0);
      tc::cp_async_commit();
    }

    // -- S = Q K^T over the padded head dim (a warpgroup's 64 rows) ---------
    tc::fence_regs<32>(s);
    tc::fence_regs<4 * KS>(qa);
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::wgmma_m64n64k16_rs<0>(s, qa + 4 * ks, tc::make_desc(Kt + ks * 256, 128, DP * 16),
                                ks > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs<32>(s);
    tc::fence_regs<4 * KS>(qa);

    const float2 corr = softmax_tile(s, m, l, geo.q0 + r0 + geo.off, kv0, t,
                                     geo.masked(kv0, qlo, 64, Skv, causal, window), Skv, causal,
                                     window, scale2);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[4 * c] *= corr.x;
      acc[4 * c + 1] *= corr.x;
      acc[4 * c + 2] *= corr.y;
      acc[4 * c + 3] *= corr.y;
    }

    // -- O += P V: P from registers, V MN-major from shared memory ----------
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = attn::pack_bf16x2(s[2 * i], s[2 * i + 1]);
    tc::fence_regs<16>(pa);
    tc::fence_regs<4 * NC>(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* vb = Vt + 2 * j * DP * 16;
#pragma unroll
      for (int n = 0; n < DP / 64; ++n)
        tc::wgmma_m64n64k16_rs<1>(acc + 32 * n, pa + 4 * j, tc::make_desc(vb + n * 1024, DP * 16, 128),
                                  1);
#pragma unroll
      for (int n = 0; n < (DP % 64) / 16; ++n)
        tc::wgmma_m64n16k16_rs<1>(acc + 32 * (DP / 64) + 8 * n, pa + 4 * j,
                                  tc::make_desc(vb + (DP / 64) * 1024 + n * 256, DP * 16, 128), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs<16>(pa);
    tc::fence_regs<4 * NC>(acc);
  }

  store_rows<__nv_bfloat16, NC>(o, acc, l, (size_t)bh * Sq, geo.q0, r0, Sq, D, geo.d0, t);
}

// ===========================================================================
// fp32: 3xTF32 on mma.sync
// ===========================================================================

constexpr int DK = 32;              // slice of d per staging step
constexpr int QKS = DK + 4;         // row stride of the q/k slices: 4 mod 32 banks

// WARPS warps of 16 rows each: 8 where that still gives every SM two blocks
// and there is no window (each K/V slice then serves 128 rows), else 4
template <int DV, int WARPS>
struct F32Cfg {
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
  static constexpr int VS = DV + 4;  // row stride of v: 4 mod 32 banks
  static constexpr int FLOATS = 2 * BQ * QKS + 2 * BKV * QKS + 2 * BKV * VS;
};

// rows x cols of a [nrows, D] fp32 or bf16 matrix (from (row0, col0)),
// widened to fp32 and split by NT threads into tf32 hi/lo planes with row
// stride ld; outside the matrix: zeros.  (A bf16 value is its own hi: lo
// is 0.)
template <int NT, typename T>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo, int ld, int rows, int cols,
                                            const T* src, int row0, int nrows, int col0, int D) {
  const int per_row = cols / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += NT) {
    const int r = e / per_row, c = (e % per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && col0 + c < D) x = attn::load4(src + (size_t)(row0 + r) * D + col0 + c);
    const tc::Split a = tc::split_tf32(x.x), b = tc::split_tf32(x.y), cc = tc::split_tf32(x.z),
                    d = tc::split_tf32(x.w);
    *reinterpret_cast<uint4*>(hi + r * ld + c) = make_uint4(a.hi, b.hi, cc.hi, d.hi);
    *reinterpret_cast<uint4*>(lo + r * ld + c) = make_uint4(a.lo, b.lo, cc.lo, d.lo);
  }
}

// T: fp32, or bf16 above d = 128 (widened as it is staged, rounded as it
// is stored)
template <typename T, int DV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
fa_f32_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal,
              int window) {
  using S = F32Cfg<DV, WARPS>;
  constexpr int NT = S::THREADS, BQF = S::BQ;
  extern __shared__ __align__(16) uint32_t fsm[];
  uint32_t* Qh = fsm;
  uint32_t* Ql = Qh + BQF * QKS;
  uint32_t* Kh = Ql + BQF * QKS;
  uint32_t* Kl = Kh + BKV * QKS;
  uint32_t* Vh = Kl + BKV * QKS;
  uint32_t* Vl = Vh + BKV * S::VS;

  const int bh = blockIdx.z;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const Geo geo = geometry(Sq, Skv, BQF, DV, causal, window);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * w + g;
  const T* Q = q + (size_t)bh * Sq * D;
  const T* K = k + (size_t)kvh * Skv * D;
  const T* V = v + (size_t)kvh * Skv * D;
  const float scale2 = scale * LOG2E;

  constexpr int NC = DV / 8;
  float acc[4 * NC], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4 * NC; ++i) acc[i] = 0.f;

  for (int kv0 = geo.kv_lo; kv0 < geo.kv_hi; kv0 += BKV) {
    // -- S = Q K^T, q and k streamed in DK-wide slices of d -----------------
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int dk0 = 0; dk0 < D; dk0 += DK) {
      stage_split<NT>(Qh, Ql, QKS, BQF, DK, Q, geo.q0, Sq, dk0, D);
      stage_split<NT>(Kh, Kl, QKS, BKV, DK, K, kv0, Skv, dk0, D);
      __syncthreads();
      float part[32];                        // this slice, added to s rounding to nearest
#pragma unroll
      for (int i = 0; i < 32; ++i) part[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; kk += 8) {
        const int ia = r0 * QKS + kk + t;
        const uint32_t ah[4] = {Qh[ia], Qh[ia + 8 * QKS], Qh[ia + 4], Qh[ia + 8 * QKS + 4]};
        const uint32_t al[4] = {Ql[ia], Ql[ia + 8 * QKS], Ql[ia + 4], Ql[ia + 8 * QKS + 4]};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int ib = (8 * c + g) * QKS + kk + t;
          const uint32_t bh2[2] = {Kh[ib], Kh[ib + 4]}, bl2[2] = {Kl[ib], Kl[ib + 4]};
          tc::mma_3xtf32_chain(part + 4 * c, ah, al, bh2, bl2);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] += part[i];
      __syncthreads();
    }

    const float2 corr = softmax_tile(s, m, l, geo.q0 + r0 + geo.off, kv0, t,
                                     geo.masked(kv0, geo.q0 + 16 * w, 16, Skv, causal, window),
                                     Skv, causal,
                                     window, scale2);

    // -- O = O * corr + P V, 64 columns at a time; key 8j+2t+e of a step
    // sits at k-slot t+4e of both operands
    stage_split<NT>(Vh, Vl, S::VS, BKV, DV, V, kv0, Skv, geo.d0, D);
    __syncthreads();
#pragma unroll
    for (int half = 0; half < NC / 8; ++half) {
      float pv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const tc::Split p0 = tc::split_tf32(s[4 * j]), p1 = tc::split_tf32(s[4 * j + 2]),
                        p2 = tc::split_tf32(s[4 * j + 1]), p3 = tc::split_tf32(s[4 * j + 3]);
        const uint32_t ah[4] = {p0.hi, p1.hi, p2.hi, p3.hi}, al[4] = {p0.lo, p1.lo, p2.lo, p3.lo};
        const int ib = (8 * j + 2 * t) * S::VS + 64 * half + g;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t bh2[2] = {Vh[ib + 8 * c], Vh[ib + S::VS + 8 * c]};
          const uint32_t bl2[2] = {Vl[ib + 8 * c], Vl[ib + S::VS + 8 * c]};
          tc::mma_3xtf32_chain(pv + 4 * c, ah, al, bh2, bl2);
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float& o = acc[32 * half + i];
        o = fmaf(o, (i & 2) ? corr.y : corr.x, pv[i]);
      }
    }
    __syncthreads();
  }

  store_rows<T, NC>(o, acc, l, (size_t)bh * Sq, geo.q0, r0, Sq, D, geo.d0, t);
}

// ===========================================================================
// launch
// ===========================================================================

template <typename... KArgs, typename... Args>
int launch_kernel(void (*kern)(KArgs...), int threads, int smem, dim3 grid, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int N, int Hq, int Hkv,
                int Sq, int Skv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid((Sq + BF16_BQ - 1) / BF16_BQ, 1, N * Hq);
  return launch_kernel(fa_bf16_kernel<DP>, BF16_THREADS, bf16_smem(DP), grid, stream,
                       static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                       static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq,
                       Hkv, Sq, Skv, D, scale, causal, window);
}

template <typename T, int DV, int WARPS>
int launch_f32_warps(const void* q, const void* k, const void* v, void* o, int N, int Hq, int Hkv,
                     int Sq, int Skv, int D, float scale, int causal, int window,
                     cudaStream_t stream) {
  using S = F32Cfg<DV, WARPS>;
  const dim3 grid((Sq + S::BQ - 1) / S::BQ, (D + DV - 1) / DV, N * Hq);
  return launch_kernel(fa_f32_kernel<T, DV, WARPS>, S::THREADS, S::FLOATS * 4, grid, stream,
                       static_cast<const T*>(q), static_cast<const T*>(k),
                       static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D, scale,
                       causal, window);
}

template <typename T, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int N, int Hq, int Hkv,
               int Sq, int Skv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const int sms = tc::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long blocks8 = (long)((Sq + 127) / 128) * ((D + DV - 1) / DV) * N * Hq;
  if (window <= 0 && blocks8 >= 2L * sms)
    return launch_f32_warps<T, DV, 8>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                                      stream);
  return launch_f32_warps<T, DV, 4>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale, causal, window,
                                    stream);
}

}  // namespace

// q [N, Hq, Sq, D], k/v [N, Hkv, Skv, D], o [N, Hq, Sq, D], contiguous, all
// of one type: dtype 0 = fp32, 1 = bf16.  D % 4 == 0, Hq % Hkv == 0;
// window <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int N,
                                      int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                                      int causal, int window, int dtype, cudaStream_t stream) {
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || D <= 0 ||
      D % 4 != 0 || N * Hq > 65535)
    return (int)cudaErrorInvalidValue;
#define FA(F, ...) F<__VA_ARGS__>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale, causal, window, stream)
  if (dtype == 0) return D <= 64 ? FA(launch_f32, float, 64) : FA(launch_f32, float, 128);
  if (dtype == 1) {
    // the head dim padded to the MMA's 16
    if (D <= 16) return FA(launch_bf16, 16);
    if (D <= 32) return FA(launch_bf16, 32);
    if (D <= 64) return FA(launch_bf16, 64);
    if (D <= 80) return FA(launch_bf16, 80);
    if (D <= 128) return FA(launch_bf16, 128);
    return FA(launch_f32, __nv_bfloat16, 128);
  }
#undef FA
  return (int)cudaErrorInvalidValue;
}
