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
// bf16 on the tensor cores.  Every path runs on the tensor cores:
//
// bf16 up to d = 128 (the LM prefill) has two routes, chosen in the
// launcher from the head dim and the operands' alignment alone (route_of),
// never as a retry of the other:
//
// bf16_tma (d % 8 == 0, 16-byte-aligned q, k, v and o: every model; the
// namespace tma), FlashAttention-3's shape.  A persistent CTA an SM of
// three warpgroups draws units (a q head's block of 128 rows) from a
// counter.  The producer's one thread loads a unit's Q and its K and V
// tiles of 128 keys by TMA (3-D maps: head dim, position, head, so rows
// past Sq or Skv arrive as zeros) in boxes of 64 columns with the 128-byte
// swizzle, into a 3-stage ring with full and empty mbarriers.  Two consumer
// warpgroups of 64 rows: S = Q K^T as wgmma.m64n128k16 with both operands
// in shared memory, the online softmax with the scale inside one FFMA a
// value, P rounded to bf16 as the register A operand of O += P V
// (wgmma.m64nNk16, N = d rounded up to 64, 80, 96, 112 or 128: no padded
// lane at d 80 or 112), V MN-major through the descriptor.  Tile it's S is
// issued before P V of tile it - 1 and its softmax runs under that
// product; the two warpgroups take the tensor cores in turns (named
// barriers), so one's softmax runs under the other's products; a unit's Q
// is freed after its last S, so the next unit's loads run under the last
// products and the stores.
//
// bf16_cp_async (d % 8 == 4, or 8-byte-aligned operands): a block of
// three warpgroups owns 192 queries, each warpgroup 64 of them, with its
// rows of Q held in registers.  S = Q K^T is wgmma.m64n64k16 with Q from
// registers and the K tile from shared memory; P is rescaled in
// registers, rounded to bf16 and fed back from registers as the A operand
// of O += P V (the accumulator fragment of S is the A fragment of P), with
// V read from shared memory through the descriptor's transpose (MN-major),
// so neither P nor a transposed V is ever written.  K/V tiles of 64 keys,
// shared by the warpgroups, arrive by cp.async into a ring of two stages,
// so the next tile's copy overlaps this tile's products.  The head dim is
// padded with zeros to the MMA depth (16).
//
// Above d = 128, which no model uses, bf16 runs through the fp32 kernels
// below: their loads widen bf16 exactly and their output rounds to bf16,
// and 3xTF32 with an fp32 P is the more accurate of the two paths.
//
// fp32 runs in 3xTF32: every operand is split into tf32 hi and lo planes
// (hi = tf32(x), lo = tf32(x - hi), rounded as cvt.rna rounds) and a
// product sums lo*hi + hi*lo + hi*hi (lo*lo dropped), which keeps
// fp32-grade products (about 2^-22 relative) at up to 165 TFLOP/s, where
// one TF32 pass keeps 2^-11.  Each short chain of products is summed in a
// fresh accumulator, then added on the CUDA cores with round-to-nearest
// (the tensor core's own accumulation drifts; see hopper_mma.cuh).
//
// fp32 up to d = 128 (fp32 LMs): mma.sync.m16n8k8, 16 query rows per warp,
// 4 or 8 warps per block (8 share each K/V slice among 128 rows, where
// the grid still fills the card twice over and no window applies).  q and
// k are streamed in 32-wide slices of d and split as they are staged, v
// in 128-column slices of the output; P stays fp32 and is split in
// registers, its accumulator fragment reused as the A fragment of P V by
// ordering each 8-key step's keys (2t, 2t+1) -> (t, t+4) on both
// operands.  Each 32-wide slice of q k^T and each tile's P V is a fresh
// fragment, the rescale of O folded into its add.  (Run above d = 128, a
// block per 128-column output slice recomputes all of S and re-splits q
// for every key tile: 2.5x the products at d = 512.)
//
// fp32 above d = 128 (the VAE's d = 512): the wide kernel (namespace
// wide), one S per (64-row block, 64-key tile), on wgmma.  A thread block
// cluster of CL = ceil(d / 128) CTAs owns 64 query rows; CTA r holds
// columns [128 r, 128 r + 128) of d, both as the depth of its part of
// q k^T and as its output columns.  A CTA is two warpgroups:
//   - the producer splits its slice of Q once into hi/lo K-major planes,
//     resident for the whole kernel; then streams K's slice and V's 128
//     columns: each tile is loaded into registers a step ahead, split and
//     stored K K-major and V transposed (keys contiguous: wgmma transposes
//     no 32-bit operand), V's keys permuted as P's fragment needs.  One
//     buffer each, handed over and back by mbarriers: K is read only
//     while S is computed and V only during P V;
//   - the consumer computes its part of S = Q_r K_r^T [64 x 64] as one
//     chain of 48 wgmma.m64n64k8 TF32 (both operands in shared memory),
//     a tile ahead of the softmax, so that the exchange of one tile's
//     parts overlaps the products of the next.  The parts are summed over
//     the cluster through distributed shared memory as a reduce-scatter
//     (CTA u % CL sums unit u of the tile over the CL parts in rank order)
//     and an all-gather, so every CTA holds the same bits of S and
//     computes the same m and l; then the online softmax, P split in
//     registers, and O += P V [64 x 128] as two chains of 24
//     wgmma.m64n64k8 TF32 with P from registers.
// Shared memory: Q 64 KB, a K and a V tile 64 KB each (hi and lo), two
// exchange buffers 32 KB: 229,504 bytes, one block an SM.  Mbarriers hand
// the tiles between the warpgroups and the exchange's steps between the
// CTAs (a remote arrive releases at cluster scope, a wait acquires).  TF32
// products a call: 3 x (2 * 64 * 64 * 128 for S and as many for P V) per
// CTA and key tile, that is 3 x 4 * Sq' * Skv' * D' (Sq' and Skv' rounded
// up to 64, tiles past the causal diagonal or before the window skipped;
// D' rounded up to 128), plus one S tile per row block past the last key
// tile (the consumer issues it unconditionally and drops it).  At the
// VAE's shapes (Sq = Skv = 4,096 or 16,384, d = 512) that is 3 x 4 Sq Skv
// d x (1 + 1 / (2 Skv / 64)): at most 1.008 x the 3xTF32 products (no S
// recomputed across output slices, Q split once).  Above d = 1,024 (more
// than 8 CTAs a cluster; no model) the mma.sync kernel runs.
//
// Every path: the longest causal rows first, so the short ones fill the
// tail (bf16_tma: within each section of heads); the kv loop is bounded by
// the causal diagonal and the window, and only tiles that cross the
// diagonal, the window's edge or Skv are masked.  Every row is reduced in
// a fixed order by the same threads, so the result does not depend on how
// many images or sequences share the launch.

#include <cooperative_groups.h>
#include <cuda.h>                       // CUtensorMap and its enums (no -lcuda)

#include "attn_common.cuh"
#include "hopper_mma.cuh"
#include "tma_map.cuh"

namespace {

namespace cg = cooperative_groups;

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
  // whether the `rows` rows from qlo need the mask on the TILE keys at kv0
  template <int TILE = BKV>
  __device__ bool masked(int kv0, int qlo, int rows, int Skv, int causal, int window) const {
    return kv0 + TILE > Skv || (causal && kv0 + TILE - 1 > qlo + off) ||
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
// 16-byte copies when `v16` (D % 8 == 0 and 16-byte-aligned k and v),
// else 8-byte ones (D % 4 == 0, 8-byte-aligned).
template <int NT>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, const __nv_bfloat16* src,
                                             int rows, int row0, int nrows, int D, int dqk,
                                             bool v16) {
  if (v16) {
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
                                        int nrows, int D, int d0, bool v16) {
  if (v16) {
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
  const bool v16 = (D & 7) == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;

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
    stage_kmajor<NT>(Ks, K, BKV, geo.kv_lo, Skv, D, DP, v16);
    stage_v<NT, DP>(Vs, V, geo.kv_lo, Skv, D, geo.d0, v16);
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
      stage_kmajor<NT>(Ks + (st ^ 1) * BKV * DP * 2, K, BKV, kv0 + BKV, Skv, D, DP, v16);
      stage_v<NT, DP>(Vs + (st ^ 1) * BKV * DP * 2, V, kv0 + BKV, Skv, D, geo.d0, v16);
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
// bf16 up to d = 128: TMA and wgmma, warp-specialised (namespace tma)
// ===========================================================================

namespace tma {

constexpr int BQ = 128;                  // query rows a CTA: two consumer warpgroups of 64
constexpr int BN = 128;                  // keys a tile
constexpr int NT = 384;                  // a producer and two consumer warpgroups
constexpr int BOX_COLS = 64;             // head-dim columns of a TMA box: 128 bytes a row
constexpr int BOX = 128 * BOX_COLS * 2;  // a box of 128 rows: 16 KB
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int SMEM_MAX = 232448;
constexpr long SECTION_BYTES = 4L << 20;   // the K and V a section's kv heads may hold

// DN: the head dim the products run at (a multiple of 16; d <= DN, the
// columns past d zero-filled by TMA): q k^T is DN / 16 steps deep, P V is
// m64nDNk16 (d 80, 96, 112 and 128 with no padded output lane).  Shared
// memory, from a 1024-aligned base: Q [128 x NB boxes], then 3 K tiles and
// 3 V tiles [128 keys x NB boxes], then the barriers: 224 KB at d 128.
template <int DN>
struct Cfg {
  static constexpr int NB = (DN + BOX_COLS - 1) / BOX_COLS;
  static constexpr int TILE = NB * BOX;
  static constexpr int STAGES = 3;
  static constexpr int K_OFF = TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int BYTES = 1024 + BAR_OFF + 256;   // 1024: room to align the base
  static_assert(DN % 16 == 0 && DN <= 128, "the instantiated head dims");
  static_assert(BYTES <= SMEM_MAX, "one block an SM");
};

// the dynamic shared memory's first 1024-aligned byte: a swizzle atom's
// pattern follows the address bits, so every box starts 1024-aligned
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (tc::smem_u32(p) & 1023u)) & 1023u);
}

// S [64 x 128] = Q K^T over DN / 16 steps of 16 head-dim columns: q (64
// rows) and k (128 keys) K-major, 128-byte-swizzled boxes of 64 columns;
// step ks reads 32 bytes on within box ks / 4.  One commit group.
template <int DN>
__device__ __forceinline__ void issue_s(float* s, uint64_t qd, uint64_t kd) {
  tc::fence_regs<64>(s);
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DN / 16; ++ks) {
    const uint32_t off = ((ks >> 2) * BOX + (ks & 3) * 32) >> 4;
    tc::wgmma_m64n128k16_ss(s, qd + off, kd + off, ks > 0);
  }
  tc::wgmma_commit();
}

// O [64 x DN] += P V over 8 steps of 16 keys: P from registers (step j's A
// fragment at pa + 4 j), V MN-major (16 keys a step, 2,048 bytes on; the
// second box of 64 columns `BOX` bytes on).  One commit group.
template <int DN>
__device__ __forceinline__ void issue_pv(float* acc, uint32_t* pa, uint64_t vd) {
  tc::fence_regs<32>(pa);
  tc::fence_regs<DN / 2>(acc);
  tc::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) tc::wgmma_pv_bf16<DN>(acc, pa + 4 * j, vd + ((j * 2048) >> 4), 1);
  tc::wgmma_commit();
}

// P (the accumulator fragment of S, rounded to bf16 to nearest-even, two
// at a time) as the A fragments of P V: step j's keys 16 j .. 16 j + 15 at
// pa[4 j .. 4 j + 3]
__device__ __forceinline__ void pack_p(uint32_t* pa, const float* s) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    pa[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// Online softmax over a 128-key tile for the two rows (qpos, qpos + 8) a
// thread holds, in softmax_tile's layout and with its m and l, the scale
// kept inside the exponent: the row's extreme of the raw s (its max, or
// its min when scale2 < 0) times scale2 is m's candidate, the same bits as
// the max of the scaled values (rounding keeps the order of a value's
// multiples), and p = 2^(s scale2 - m) is one FFMA and one ex2.  On a
// masked tile a hidden key's s is set to the extreme that never wins
// (-inf, or +inf when scale2 < 0) and its p to 0; no key kept yet makes
// m's candidate -inf (or NaN at scale 0, which fmaxf drops), and then
// every p is 0, as softmax_tile gives.
template <bool MASKED>
__device__ __forceinline__ float2 softmax_128(float* s, float* m, float* l, int qpos, int kv0,
                                              int t, int Skv, int causal, int window,
                                              float scale2) {
  const bool up = scale2 >= 0.f;
  const float hide = up ? -INFINITY : INFINITY;
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kp = kv0 + 8 * (i >> 2) + 2 * t + (i & 1), qp = qpos + 8 * ((i >> 1) & 1);
      const bool keep = kp < Skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      s[i] = keep ? s[i] : hide;
    }
  }
  float mx[2] = {hide, hide};
  if (up) {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fminf(mx[(i >> 1) & 1], s[i]);
  }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float a = __shfl_xor_sync(0xffffffffu, mx[h], 1);
    mx[h] = up ? fmaxf(mx[h], a) : fminf(mx[h], a);
    const float b = __shfl_xor_sync(0xffffffffu, mx[h], 2);
    mx[h] = (up ? fmaxf(mx[h], b) : fminf(mx[h], b)) * scale2;
    const float m_new = fmaxf(m[h], mx[h]);
    // no key kept yet: exponentiate against 0, so every p is 2^-inf = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = ex2(m[h] - m_use);
    m[h] = m_new;
    mx[h] = -m_use;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale2, mx[h]));
    if (MASKED) p = s[i] == hide ? 0.f : p;
    s[i] = p;
    rs[h] += p;
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
  return make_float2(corr[0], corr[1]);
}

template <int DN>
__device__ __forceinline__ void rescale(float* acc, float2 corr) {
#pragma unroll
  for (int c = 0; c < DN / 8; ++c) {
    acc[4 * c] *= corr.x;
    acc[4 * c + 1] *= corr.x;
    acc[4 * c + 2] *= corr.y;
    acc[4 * c + 3] *= corr.y;
  }
}

// The unit u of a call's nbh x nqb (q head, block of 128 rows): sections
// of `hs` consecutive q heads, each walked block by block from the longest
// causal block down, so the units in flight share few kv heads (their K
// and V stay in L2) and the last units drawn are the shortest.  Its head,
// first row and keys:
struct Unit {
  int bh;
  Geo geo;
  int ntiles;
};

__device__ __forceinline__ Unit unit_of(int u, int nbh, int nqb, int hs, int Sq, int Skv,
                                        int causal, int window) {
  const int sec = u / (hs * nqb), r = u - sec * hs * nqb;
  const int h = min(hs, nbh - sec * hs);         // heads of this section
  Unit w;
  w.bh = sec * hs + r % h;
  Geo& g = w.geo;
  g.q0 = (nqb - 1 - r / h) * BQ;
  g.d0 = 0;
  g.off = Skv - Sq;
  g.kv_lo = window > 0 ? max(0, g.q0 + g.off - window + 1) / BN * BN : 0;
  g.kv_hi = causal ? min(Skv, min(g.q0 + BQ, Sq) + g.off) : Skv;
  w.ntiles = g.kv_hi > g.kv_lo ? (g.kv_hi - g.kv_lo + BN - 1) / BN : 0;
  return w;
}

// A persistent CTA an SM.  Warpgroup 0 is the producer: one thread draws
// the CTA's next unit from `counter` (zeroed before the launch) once both
// consumers are done with the last one's Q, hands it over in shared memory
// on Q's barrier, and loads the unit's Q and its K and V tiles of 128 keys
// by TMA into a ring of STAGES that runs on across units, each tile's K
// and V on full barriers of their own, reloading a stage once both
// consumers have freed it; a draw past the last unit ends the CTA.  So a
// unit's loads run under the last one's products and stores.  Warpgroups
// 1 and 2 are the consumers, 64 rows each: S = Q K^T from shared memory,
// the online softmax in registers, P rounded to bf16 as the A operand of
// O += P V, the rows stored from registers.  The maps are 3-D (head dim,
// position, head): rows past Sq or Skv arrive as zeros, never another
// head's.  A unit's result does not depend on which CTA draws it.
template <int DN>
__global__ void __launch_bounds__(NT, 1)
fa_bf16_tma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
                   int* __restrict__ counter, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                   int causal, int window, int nbh, int nqb, int hs) {
  using C = Cfg<DN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  unsigned char* const Qs = sm;
  unsigned char* const Ks = sm + C::K_OFF;
  unsigned char* const Vs = sm + C::V_OFF;
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* const full_v = full_k + C::STAGES;
  uint64_t* const empty = full_v + C::STAGES;
  uint64_t* const full_q = empty + C::STAGES;
  uint64_t* const empty_q = full_q + 1;
  int* const slot = reinterpret_cast<int*>(empty_q + 1);   // the unit handed over
  const int units = nqb * nbh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      tc::mbar_init(&full_k[st], 1);
      tc::mbar_init(&full_v[st], 1);
      tc::mbar_init(&empty[st], 8);          // a warp of each consumer warpgroup
    }
    tc::mbar_init(full_q, 1);
    tc::mbar_init(empty_q, 8);
    tc::mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // -- the producer: one thread draws the units and issues every load -----
    tc::regs_lower<PRODUCER_REGS>();
    if (tid == 0) {
      tc::prefetch_tensormap(&mq);
      tc::prefetch_tensormap(&mk);
      tc::prefetch_tensormap(&mv);
      for (int j = 0, kt = 0;; ++j) {        // j: units drawn, kt: tiles loaded
        if (j > 0) tc::mbar_wait(empty_q, (j - 1) & 1);
        const int u = atomicAdd(counter, 1);
        *slot = u;
        if (u >= units) {
          tc::mbar_arrive(full_q);
          break;
        }
        const Unit w = unit_of(u, nbh, nqb, hs, Sq, Skv, causal, window);
        if (w.ntiles == 0) {
          tc::mbar_arrive(full_q);
          continue;
        }
        const int kvh = (w.bh / Hq) * Hkv + (w.bh % Hq) / (Hq / Hkv);
        tc::mbar_arrive_expect_tx(full_q, C::TILE);
#pragma unroll
        for (int b = 0; b < C::NB; ++b)
          tc::tma_load_3d(Qs + b * BOX, &mq, b * BOX_COLS, w.geo.q0, w.bh, full_q);
        for (int it = 0; it < w.ntiles; ++it, ++kt) {
          const int st = kt % C::STAGES, kv0 = w.geo.kv_lo + it * BN;
          if (kt >= C::STAGES) tc::mbar_wait(&empty[st], (kt / C::STAGES - 1) & 1);
          tc::mbar_arrive_expect_tx(&full_k[st], C::TILE);
#pragma unroll
          for (int b = 0; b < C::NB; ++b)
            tc::tma_load_3d(Ks + st * C::TILE + b * BOX, &mk, b * BOX_COLS, kv0, kvh, &full_k[st]);
          tc::mbar_arrive_expect_tx(&full_v[st], C::TILE);
#pragma unroll
          for (int b = 0; b < C::NB; ++b)
            tc::tma_load_3d(Vs + st * C::TILE + b * BOX, &mv, b * BOX_COLS, kv0, kvh, &full_v[st]);
        }
      }
    }
    return;
  }

  // -- the consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64) ----
  tc::regs_raise<CONSUMER_REGS>();
  const int wg = warp / 4 - 1, g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * (warp % 4) + g;   // the thread's rows r0, r0 + 8 of a block
  const float scale2 = scale * LOG2E;
  float acc[DN / 2], s[64], m[2], l[2];
  uint32_t pa[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = 0u;
  // descriptors of this warpgroup's Q rows and of stage 0's K and V tiles;
  // stage st is st tiles on
  const uint64_t qd = tc::make_desc_sw128(Qs + wg * 64 * 128, 16, 1024);
  const uint64_t kd = tc::make_desc_sw128(Ks, 16, 1024);
  const uint64_t vd = tc::make_desc_sw128(Vs, BOX, 1024);
  auto stage_off = [](int kt) { return (uint64_t)(((kt % C::STAGES) * C::TILE) >> 4); };
  auto parity = [](int kt) { return (kt / C::STAGES) & 1; };
  // the tensor cores taken in turns, so one warpgroup's softmax runs under
  // the other's products: warpgroup 0 first (warpgroup 1 arrives once
  // ahead); each waits on its own barrier and hands over after issuing
  auto turn_take = [&]() { tc::named_bar_sync(1 + wg, 256); };
  auto turn_give = [&]() { tc::named_bar_arrive(2 - wg, 256); };
  // a warp of each warpgroup frees a stage (or Q) once its products are
  // done
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(bar);
  };
  if (wg == 1) tc::named_bar_arrive(1, 256);

  for (int j = 0, kt = 0;; ++j) {            // as the producer counts them
    tc::mbar_wait(full_q, j & 1);
    const int u = *slot;
    if (u >= units) break;
    const Unit w = unit_of(u, nbh, nqb, hs, Sq, Skv, causal, window);
    const Geo& geo = w.geo;
    const int ntiles = w.ntiles, qlo = geo.q0 + 64 * wg, qpos = geo.q0 + r0 + geo.off;
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    auto softmax = [&](int it) {
      const int kv0 = geo.kv_lo + it * BN;
      return geo.masked<BN>(kv0, qlo, 64, Skv, causal, window)
                 ? softmax_128<true>(s, m, l, qpos, kv0, t, Skv, causal, window, scale2)
                 : softmax_128<false>(s, m, l, qpos, kv0, t, Skv, causal, window, scale2);
    };
    if (ntiles > 0) {
      turn_take();
      tc::mbar_wait(&full_k[kt % C::STAGES], parity(kt));
      issue_s<DN>(s, qd, kd + stage_off(kt));
      turn_give();
      tc::wgmma_wait<0>();
      tc::fence_regs<64>(s);
      if (ntiles == 1) release(empty_q);     // the unit's last S is done: Q is free
      float2 corr = softmax(0);
      pack_p(pa, s);
      for (int it = 1; it < ntiles; ++it) {
        const int kc = kt + it;
        turn_take();
        tc::mbar_wait(&full_k[kc % C::STAGES], parity(kc));
        issue_s<DN>(s, qd, kd + stage_off(kc));            // S(it)
        rescale<DN>(acc, corr);                            // ... under S(it)
        tc::mbar_wait(&full_v[(kc - 1) % C::STAGES], parity(kc - 1));
        issue_pv<DN>(acc, pa, vd + stage_off(kc - 1));     // P V(it - 1)
        turn_give();
        tc::wgmma_wait<1>();                               // S(it) done
        tc::fence_regs<64>(s);
        if (it == ntiles - 1) release(empty_q);
        corr = softmax(it);                                // ... under P V(it - 1)
        tc::wgmma_wait<0>();
        tc::fence_regs<DN / 2>(acc);
        tc::fence_regs<32>(pa);
        release(&empty[(kc - 1) % C::STAGES]);
        pack_p(pa, s);
      }
      const int kl = kt + ntiles - 1;
      rescale<DN>(acc, corr);
      turn_take();
      tc::mbar_wait(&full_v[kl % C::STAGES], parity(kl));
      issue_pv<DN>(acc, pa, vd + stage_off(kl));
      turn_give();
      tc::wgmma_wait<0>();
      tc::fence_regs<DN / 2>(acc);
      tc::fence_regs<32>(pa);
      release(&empty[kl % C::STAGES]);
      kt += ntiles;
    } else {
      release(empty_q);
    }
    store_rows<__nv_bfloat16, DN / 8>(o, acc, l, (size_t)w.bh * Sq, geo.q0, r0, Sq, D, 0, t);
  }
}

// One S and one P V through the kernel's TMA boxes, swizzle and operand
// layouts: s [64 x 128] = q [64 x d] k [128 x d]^T and o [64 x d] = p [64 x
// 128] v [128 x d], p entering in S's accumulator layout; q's box reaches
// past its 64 rows (zeros).  One warpgroup, one block.
template <int DN>
__global__ void __launch_bounds__(128)
bf16_probe_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __nv_bfloat16* __restrict__ p,
                  float* __restrict__ s_out, float* __restrict__ o_out, int D) {
  using C = Cfg<DN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(sm + 3 * C::TILE);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(bar, 3 * C::TILE);
    for (int b = 0; b < C::NB; ++b) {
      tc::tma_load_3d(sm + b * BOX, &mq, b * BOX_COLS, 0, 0, bar);
      tc::tma_load_3d(sm + C::TILE + b * BOX, &mk, b * BOX_COLS, 0, 0, bar);
      tc::tma_load_3d(sm + 2 * C::TILE + b * BOX, &mv, b * BOX_COLS, 0, 0, bar);
    }
  }
  tc::mbar_wait(bar, 0);
  const int r = 16 * w + g;
  float s[64], acc[DN / 2];
  uint32_t pa[32];
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * c + e] = __bfloat162float(p[(r + 8 * (e >> 1)) * 128 + 8 * c + 2 * t + (e & 1)]);
  pack_p(pa, s);
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  issue_s<DN>(s, tc::make_desc_sw128(sm, 16, 1024), tc::make_desc_sw128(sm + C::TILE, 16, 1024));
  issue_pv<DN>(acc, pa, tc::make_desc_sw128(sm + 2 * C::TILE, BOX, 1024));
  tc::wgmma_wait<0>();
  tc::fence_regs<64>(s);
  tc::fence_regs<DN / 2>(acc);
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), col = 8 * c + 2 * t + (e & 1);
      s_out[row * 128 + col] = s[4 * c + e];
      if (c < DN / 8 && col < D) o_out[row * D + col] = acc[4 * c + e];
    }
}

}  // namespace tma

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
// fp32 above d = 128: 3xTF32 on wgmma, one S per (row block, key tile)
// ===========================================================================

namespace wide {

constexpr int BQ = 64;                   // query rows of a cluster: wgmma's M
constexpr int DS = 128;                  // columns of d a CTA holds
constexpr int MAX_D = 8 * DS;            // clusters of up to 8 CTAs (portable)
constexpr int NT = 256;                  // a producer and a consumer warpgroup
constexpr int QKG = BQ * 16;             // a 4-column group of Q's rows, bytes
constexpr int KKG = BKV * 16;            // ... of a K tile's keys
constexpr int QPLANE = DS / 4 * QKG;     // Q's hi or lo plane: 32 KB
constexpr int KPLANE = DS / 4 * KKG;     // a K tile's: 32 KB
constexpr int VSG = DS * 16;             // 4 key slots of V's 128 columns, bytes
constexpr int VPLANE = BKV / 4 * VSG;    // a V tile's hi or lo plane: 32 KB
constexpr int XF = BQ * BKV;             // floats of a partial S tile
enum Bar {
  kQFull, kKFull, kKEmpty, kVFull, kVEmpty,
  kXFull, kSFull = kXFull + 2, kXEmpty = kSFull + 2, kBars = kXEmpty + 2
};
constexpr int Q_OFF = 128;               // after the barriers
constexpr int K_OFF = Q_OFF + 2 * QPLANE;
constexpr int V_OFF = K_OFF + 2 * KPLANE;
constexpr int X_OFF = V_OFF + 2 * VPLANE;  // two partial S tiles
constexpr int BYTES = X_OFF + 2 * XF * 4;
static_assert(kBars * 8 <= Q_OFF, "the barriers fit");
static_assert(BYTES <= 232448, "one block an SM");

// byte offset of (row r, column c) in a Q or K plane: K-major no-swizzle
// core matrices, a 4-column group of all rows one run of `kg` bytes (16 a
// row), so a k8 slice's descriptor strides kg bytes along K and 128 (8
// rows) along M or N
__host__ __device__ constexpr int kmaj(int r, int c, int kg) {
  return (c >> 2) * kg + r * 16 + (c & 3) * 4;
}

// V as the B operand of P V, K-major (keys contiguous): byte offset of
// column n, key slot s in a V plane.  Slot 8j + u of an 8-key step holds
// key 8j + 2u for u < 4 and key 8j + 2(u - 4) + 1 above, the order in
// which the accumulator fragment of S (keys 2t, 2t+1 of a thread) is the
// A fragment of P (k slots t, t + 4).
__host__ __device__ constexpr int vslot_off(int n, int s) {
  return (s >> 2) * VSG + n * 16 + (s & 3) * 4;
}

// A producer thread p's 16 (row, 4-column group) units of a 64-row tile:
// a quarter warp stores one group of 8 consecutive rows (16 bytes each, no
// bank conflict), a warp reads 64 contiguous bytes of each of its rows
__device__ __forceinline__ int unit_row(int p, int i) { return 8 * (i & 7) + (p & 7); }
__device__ __forceinline__ int unit_col(int p, int i) {
  return 32 * (p >> 5) + 16 * (i >> 3) + 4 * ((p & 31) >> 3);
}

// rows [row0, row0 + 64) x columns [col0, col0 + 128) of a [nrows, D]
// matrix, widened to fp32: producer thread p's units (zeros outside),
// the rows walked by one pointer
template <typename T>
__device__ __forceinline__ void load_tile(float4 (&x)[16], const T* src, int row0, int nrows,
                                          int col0, int D, int p) {
  const int r0 = row0 + unit_row(p, 0), c0 = col0 + unit_col(p, 0);
  const T* rp = src + (size_t)r0 * D + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i, rp += (size_t)8 * D) {
    const bool in = r0 + 8 * i < nrows;
    x[i] = in && c0 < D ? attn::load4(rp) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[i + 8] = in && c0 + 16 < D ? attn::load4(rp + 16) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ... split into tf32 hi and lo, stored K-major into the hi plane at `hi`
// and the lo plane `plane` bytes on
__device__ __forceinline__ void store_tile(unsigned char* hi, int plane, const float4 (&x)[16],
                                           int p) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int off = kmaj(unit_row(p, i), unit_col(p, i), 1024);
    const tc::Split a = tc::split_rna(x[i].x), b = tc::split_rna(x[i].y),
                    c = tc::split_rna(x[i].z), d = tc::split_rna(x[i].w);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(a.hi, b.hi, c.hi, d.hi);
    *reinterpret_cast<uint4*>(hi + plane + off) = make_uint4(a.lo, b.lo, c.lo, d.lo);
  }
}

// keys [row0, row0 + 8) of columns [c0, c0 + 4) of a [nrows, D] matrix,
// widened to fp32 (zeros outside): a warp reads 512 contiguous bytes of a
// row when its lanes take consecutive column quads
template <typename T>
__device__ __forceinline__ void load_v_group(float4 (&y)[8], const T* src, int row0, int nrows,
                                             int c0, int D) {
  const T* rp = src + (size_t)row0 * D + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i, rp += D)
    y[i] = row0 + i < nrows && c0 < D ? attn::load4(rp) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ... split and stored as columns 4 cq .. 4 cq + 3 of a V plane, key slots
// 8 g .. 8 g + 7 (keys permuted as vslot_off says: one 16-byte store of
// keys 0, 2, 4, 6 and one of 1, 3, 5, 7 a column and plane).  At step c a
// lane stores column 4 cq + ((c + lane / 2) & 3): a quarter warp's eight
// 16-byte stores then hit distinct banks.
__device__ __forceinline__ void store_v_group(unsigned char* hi, int plane, const float4 (&y)[8],
                                              int cq, int g, int lane) {
  const int rot = (lane >> 1) & 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int cc = (c + rot) & 3;
    tc::Split e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = tc::split_rna(cc == 0 ? y[i].x : cc == 1 ? y[i].y : cc == 2 ? y[i].z : y[i].w);
    unsigned char* const even = hi + vslot_off(4 * cq + cc, 8 * g);
    unsigned char* const odd = hi + vslot_off(4 * cq + cc, 8 * g + 4);
    *reinterpret_cast<uint4*>(even) = make_uint4(e[0].hi, e[2].hi, e[4].hi, e[6].hi);
    *reinterpret_cast<uint4*>(odd) = make_uint4(e[1].hi, e[3].hi, e[5].hi, e[7].hi);
    *reinterpret_cast<uint4*>(even + plane) = make_uint4(e[0].lo, e[2].lo, e[4].lo, e[6].lo);
    *reinterpret_cast<uint4*>(odd + plane) = make_uint4(e[1].lo, e[3].lo, e[5].lo, e[7].lo);
  }
}

// P (the accumulator fragment of S, NJ 8-key steps) as the A fragments
// of P V, split into hi and lo: step j's keys (2t, 2t+1) at slots (t, t+4)
template <int NJ>
__device__ __forceinline__ void split_p(const float* s, uint32_t* ph, uint32_t* pl) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const tc::Split a0 = tc::split_rna(s[4 * j]), a1 = tc::split_rna(s[4 * j + 2]),
                    a2 = tc::split_rna(s[4 * j + 1]), a3 = tc::split_rna(s[4 * j + 3]);
    ph[4 * j] = a0.hi;
    ph[4 * j + 1] = a1.hi;
    ph[4 * j + 2] = a2.hi;
    ph[4 * j + 3] = a3.hi;
    pl[4 * j] = a0.lo;
    pl[4 * j + 1] = a1.lo;
    pl[4 * j + 2] = a2.lo;
    pl[4 * j + 3] = a3.lo;
  }
}

// T: fp32, or bf16 (widened as it is staged: its lo planes are zeros;
// rounded as it is stored).  A cluster of CL = ceil(D / 128) CTAs per 64
// query rows; CTA `rank` holds columns [128 rank, 128 rank + 128) of d.
template <typename T, int CL>
__global__ void __launch_bounds__(NT, 1)
fa_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
               int causal, int window) {
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* const bar = reinterpret_cast<uint64_t*>(sm);
  unsigned char* const Qs = sm + Q_OFF;
  unsigned char* const Ks = sm + K_OFF;
  unsigned char* const Vs = sm + V_OFF;
  float* const X = reinterpret_cast<float*>(sm + X_OFF);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();

  // the cluster's rows, the longest causal rows first; its keys
  Geo geo;
  geo.q0 = ((int)(gridDim.x / CL) - 1 - (int)(blockIdx.x / CL)) * BQ;
  geo.d0 = rank * DS;
  geo.off = Skv - Sq;
  geo.kv_lo = window > 0 ? max(0, geo.q0 + geo.off - window + 1) / BKV * BKV : 0;
  geo.kv_hi = causal ? min(Skv, min(geo.q0 + BQ, Sq) + geo.off) : Skv;
  const int ntiles = geo.kv_hi > geo.kv_lo ? (geo.kv_hi - geo.kv_lo + BKV - 1) / BKV : 0;

  const int bh = blockIdx.z;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const T* Q = q + (size_t)bh * Sq * D;
  const T* K = k + (size_t)kvh * Skv * D;
  const T* V = v + (size_t)kvh * Skv * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    tc::mbar_init(&bar[kQFull], 128);
    tc::mbar_init(&bar[kKFull], 128);
    tc::mbar_init(&bar[kVFull], 128);
    tc::mbar_init(&bar[kKEmpty], 4);
    tc::mbar_init(&bar[kVEmpty], 4);
    for (int b = 0; b < 2; ++b) {
      tc::mbar_init(&bar[kXFull + b], 4 * CL);
      tc::mbar_init(&bar[kSFull + b], 4 * CL);
      tc::mbar_init(&bar[kXEmpty + b], 4 * CL);
    }
    tc::mbar_init_fence();
  }
  cluster.sync();                            // every CTA's barriers, before any arrives

  if (warp < 4) {
    // -- the producer: Q's slice once; then K's slice and V's columns,
    // split hi/lo and stored as their buffers free.  K runs a tile ahead
    // of V, as the consumer's S does: step it stores K(it + 1) once S(it)
    // is done and V(it) once P V(it - 1) is (K(ntiles), past the keys,
    // feeds the consumer's last S, which it drops).  Each buffer's next
    // tile is loaded into registers as soon as its last one is stored, so
    // a load has a whole step to arrive.
    float4 x[16];
    // V: this thread's column quad vq, key groups vg and vg + 4 of a tile
    float4 y[2][8];
    const int vq = tid & 31, vg = tid >> 5;
    auto load_v = [&](int kv) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        load_v_group(y[h], V, kv + 8 * (vg + 4 * h), Skv, geo.d0 + 4 * vq, D);
    };
    auto store_v = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) store_v_group(Vs, VPLANE, y[h], vq, vg + 4 * h, lane);
    };
    load_tile(x, Q, geo.q0, Sq, geo.d0, D, tid);
    store_tile(Qs, QPLANE, x, tid);
    tc::fence_proxy_async();                 // for the wgmmas that read it
    tc::mbar_arrive(&bar[kQFull]);
    if (ntiles > 0) {
      load_tile(x, K, geo.kv_lo, Skv, geo.d0, D, tid);
      store_tile(Ks, KPLANE, x, tid);
      tc::fence_proxy_async();
      tc::mbar_arrive(&bar[kKFull]);
      load_tile(x, K, geo.kv_lo + BKV, Skv, geo.d0, D, tid);
      load_v(geo.kv_lo);
    }
    for (int it = 0; it < ntiles; ++it) {
      const int kv0 = geo.kv_lo + it * BKV;
      tc::mbar_wait(&bar[kKEmpty], it & 1);
      store_tile(Ks, KPLANE, x, tid);        // K(it + 1)
      tc::fence_proxy_async();
      tc::mbar_arrive(&bar[kKFull]);
      if (it + 2 <= ntiles) load_tile(x, K, kv0 + 2 * BKV, Skv, geo.d0, D, tid);
      if (it > 0) tc::mbar_wait(&bar[kVEmpty], (it - 1) & 1);
      store_v();                             // V(it)
      tc::fence_proxy_async();
      tc::mbar_arrive(&bar[kVFull]);
      if (it + 1 < ntiles) load_v(kv0 + BKV);
    }
  } else {
    // -- the consumer warpgroup: 64 rows x this CTA's 128 output columns.
    // S runs a tile ahead of the softmax and P V: S(it + 1) is issued
    // while S(it) is gathered, and its part is published and reduced
    // before the next step gathers it.  No wgmma is issued conditionally,
    // and no register of one in flight is touched (either makes ptxas
    // serialise every wgmma of the kernel).
    const int ct = tid - 128, wq = warp - 4, g = lane / 4, t = lane % 4;
    const int r0 = 16 * wq + g;              // the thread's rows r0, r0 + 8
    const float scale2 = scale * LOG2E;
    float acc[DS / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) acc[i] = 0.f;
    // descriptors of the planes' first bytes (hi; lo a plane on); a k8
    // slice is two 4-column groups (or slot groups) on
    const uint64_t qd = tc::make_desc(Qs, QKG, 128), kd = tc::make_desc(Ks, KKG, 128);
    const uint64_t vd = tc::make_desc(Vs, VSG, 128);

    // this CTA's part of S = Q K^T (its 128 columns of d): one chain of 48
    // products in a fresh accumulator, committed as one group
    auto s_part = [&](float* d) {
      tc::fence_regs<32>(d);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 8; ++kk) {
        const uint64_t a = qd + (uint64_t)((2 * kk * QKG) >> 4);
        const uint64_t b = kd + (uint64_t)((2 * kk * KKG) >> 4);
        tc::wgmma_m64n64k8_tf32_ss(d, a + (QPLANE >> 4), b, kk > 0);
        tc::wgmma_m64n64k8_tf32_ss(d, a, b + (KPLANE >> 4), 1);
        tc::wgmma_m64n64k8_tf32_ss(d, a, b, 1);
      }
      tc::wgmma_commit();
    };
    // The exchange of tile i's parts of S, through buffer i % 2 of every
    // CTA, as a reduce-scatter then an all-gather (a CTA reads half the
    // remote bytes it would read to sum every part itself).  Unit u (0..31)
    // of a buffer is the 16 bytes a thread of warp u / 8 holds of its
    // fragment's float4 u % 8, at float 512 (u % 8) + 128 (u / 8) + 4 lane;
    // CTA u % CL keeps its sum.
    //   publish: this CTA's part into its buffer (once every CTA has
    //     gathered the tile there before), announced to every CTA;
    //   reduce: the units this CTA keeps, summed over the CTAs' parts in
    //     rank order, written over its own part there, announced;
    //   gather: this warp's 8 units from the CTAs that keep them.
    // All of them hold the same bits of S.
    auto unit_off = [&](int u) { return 512 * (u & 7) + 128 * (u >> 3) + 4 * lane; };
    auto part_of = [&](float* xs, int r) -> const float* {
      return r == rank ? xs : cluster.map_shared_rank(xs, r);
    };
    auto publish = [&](const float* d, int i) {
      float* const xs = X + (i & 1) * XF;
      if (i >= 2) tc::mbar_wait_cluster(&bar[kXEmpty + (i & 1)], ((i >> 1) - 1) & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(xs + unit_off(8 * wq + j)) =
            make_float4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
      __syncwarp();
      if (lane < CL) tc::mbar_arrive_rank(&bar[kXFull + (i & 1)], lane);
    };
    constexpr int KEPT = (32 + CL - 1) / CL, UPW = (KEPT + 3) / 4;   // units a CTA, a warp
    // a warp's loads of the reduce are issued before P V runs when they
    // fit in 32 registers (CL = 2, 4, 8), else issued and summed after it
    constexpr bool EARLY = UPW * CL <= 8;
    float4 rv[UPW][CL];
    auto reduce_load = [&](int i) {
      float* const xs = X + (i & 1) * XF;
      tc::mbar_wait_cluster(&bar[kXFull + (i & 1)], (i >> 1) & 1);
#pragma unroll
      for (int n = 0; n < UPW; ++n) {
        const int u = rank + CL * (wq + 4 * n);
        if (u < 32)
#pragma unroll
          for (int r = 0; r < CL; ++r)
            rv[n][r] = *reinterpret_cast<const float4*>(part_of(xs, r) + unit_off(u));
      }
    };
    auto reduce_finish = [&](int i) {
      float* const xs = X + (i & 1) * XF;
#pragma unroll
      for (int n = 0; n < UPW; ++n) {
        const int u = rank + CL * (wq + 4 * n);
        if (u >= 32) continue;
        float4 a = rv[n][0];
#pragma unroll
        for (int r = 1; r < CL; ++r) {
          a.x += rv[n][r].x;
          a.y += rv[n][r].y;
          a.z += rv[n][r].z;
          a.w += rv[n][r].w;
        }
        *reinterpret_cast<float4*>(xs + unit_off(u)) = a;
      }
      __syncwarp();
      if (lane < CL) tc::mbar_arrive_rank(&bar[kSFull + (i & 1)], lane);
    };
    float s[32], sn[32];
    if (ntiles > 0) {
      tc::mbar_wait(&bar[kQFull], 0);
      tc::mbar_wait(&bar[kKFull], 0);
      s_part(s);
      tc::wgmma_wait<0>();
      tc::fence_regs<32>(s);
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(&bar[kKEmpty]);
      publish(s, 0);
      reduce_load(0);
      reduce_finish(0);
    }

    for (int it = 0; it < ntiles; ++it) {
      const int kv0 = geo.kv_lo + it * BKV, xb = it & 1;

      // -- the whole S(it), gathered while S(it + 1) is issued (a
      // warpgroup's wgmma issue stalls until the tensor core takes it)
      {
        float* const xs = X + xb * XF;
        tc::mbar_wait_cluster(&bar[kSFull + xb], (it >> 1) & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = 8 * wq + j;
          const float4 a = *reinterpret_cast<const float4*>(part_of(xs, u % CL) + unit_off(u));
          s[4 * j] = a.x;
          s[4 * j + 1] = a.y;
          s[4 * j + 2] = a.z;
          s[4 * j + 3] = a.w;
        }
      }
      tc::mbar_wait(&bar[kKFull], (it + 1) & 1);
      s_part(sn);                            // S(it + 1), in flight
      __syncwarp();
      if (lane < CL) tc::mbar_arrive_rank(&bar[kXEmpty + xb], lane);

      // -- S(it + 1) is done: its part goes out before this step's softmax
      // and P V, so the other CTAs have it well before they reduce it
      tc::wgmma_wait<0>();
      tc::fence_regs<32>(sn);
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(&bar[kKEmpty]);
      if (it + 1 < ntiles) publish(sn, it + 1);

      // -- online softmax; P split in registers as P V's A operand
      const float2 corr = softmax_tile(s, m, l, geo.q0 + r0 + geo.off, kv0, t,
                                       geo.masked(kv0, geo.q0, BQ, Skv, causal, window), Skv,
                                       causal, window, scale2);
      uint32_t ph[32], pl[32];
      split_p<8>(s, ph, pl);

      // -- O = O * corr + P V over this CTA's 128 columns, as two chains of
      // 24 products (64 columns each) in fresh accumulators, each added with
      // round-to-nearest
      tc::mbar_wait(&bar[kVFull], it & 1);
      if (EARLY && it + 1 < ntiles) reduce_load(it + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pv[32];
        tc::fence_regs<32>(pv);
        tc::fence_regs<32>(ph);
        tc::fence_regs<32>(pl);
        tc::wgmma_fence();
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          const uint64_t vb = vd + (uint64_t)((2 * j * VSG + 64 * h * 16) >> 4);
          tc::wgmma_m64n64k8_tf32_rs(pv, pl + 4 * j, vb, j > 0);
          tc::wgmma_m64n64k8_tf32_rs(pv, ph + 4 * j, vb + (VPLANE >> 4), 1);
          tc::wgmma_m64n64k8_tf32_rs(pv, ph + 4 * j, vb, 1);
        }
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::fence_regs<32>(pv);
        tc::fence_regs<32>(ph);
        tc::fence_regs<32>(pl);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[32 * h + i] = fmaf(acc[32 * h + i], (i & 2) ? corr.y : corr.x, pv[i]);
      }
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(&bar[kVEmpty]);
      if (it + 1 < ntiles) {
        if (!EARLY) reduce_load(it + 1);
        reduce_finish(it + 1);
      }
    }
    store_rows<T, DS / 8>(o, acc, l, (size_t)bh * Sq, geo.q0, r0, Sq, D, geo.d0, t);
  }
  cluster.sync();                            // no CTA leaves while others read its parts
}

// One wgmma of each of the kernel's two products through its operand
// layouts, on TF32-exact inputs (each used as its hi, lo being 0): o [64 x
// 128] = p [64 x 8] v [8 x 128] as two 64-column halves, p from registers
// in S's accumulator layout through split_p and v through store_v_group's
// key slots; and s [64 x 64] = q [64 x 8] k [64 x 8]^T with q and k in Q's
// and K's planes.  One block of 128 threads.
__global__ void __launch_bounds__(128) wide_probe_kernel(const float* p, const float* v,
                                                         const float* q, const float* kk,
                                                         float* o, float* s) {
  __shared__ __align__(128) unsigned char qs[2 * QKG];     // 8 columns: two groups
  __shared__ __align__(128) unsigned char ks[2 * KKG];
  __shared__ __align__(128) unsigned char vs[2 * 2 * VSG];  // 8 keys: hi, lo
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  for (int e = tid; e < 64 * 8; e += 128) {
    const int r = e / 8, c = e % 8;
    *reinterpret_cast<uint32_t*>(qs + kmaj(r, c, QKG)) = __float_as_uint(q[e]);
    *reinterpret_cast<uint32_t*>(ks + kmaj(r, c, KKG)) = __float_as_uint(kk[e]);
  }
  if (tid < 32) {
    float4 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = *reinterpret_cast<const float4*>(v + i * DS + 4 * tid);
    store_v_group(vs, 2 * VSG, y, tid, 0, tid);
  }
  tc::fence_proxy_async();
  __syncthreads();
  const int r = 16 * w + g;
  const float pf[4] = {p[r * 8 + 2 * t], p[r * 8 + 2 * t + 1], p[(r + 8) * 8 + 2 * t],
                       p[(r + 8) * 8 + 2 * t + 1]};
  uint32_t ph[4], pl[4];
  split_p<1>(pf, ph, pl);
  float sv[32], ov[64];
  tc::fence_regs<32>(sv);
  tc::fence_regs<64>(ov);
  tc::fence_regs<4>(ph);
  tc::wgmma_fence();
  tc::wgmma_m64n64k8_tf32_ss(sv, tc::make_desc(qs, QKG, 128), tc::make_desc(ks, KKG, 128), 0);
  tc::wgmma_m64n64k8_tf32_rs(ov, ph, tc::make_desc(vs, VSG, 128), 0);
  tc::wgmma_m64n64k8_tf32_rs(ov + 32, ph, tc::make_desc(vs + 64 * 16, VSG, 128), 0);
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs<32>(sv);
  tc::fence_regs<64>(ov);
  tc::fence_regs<4>(ph);
  for (int j = 0; j < 16; ++j)                      // o's halves: columns 0-63, 64-127
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
      o[row * DS + col] = ov[4 * j + e];
      if (j < 8) s[row * 64 + col] = sv[4 * j + e];
    }
}

}  // namespace wide

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

// a 3-D map of a contiguous bf16 [heads, rows, D] tensor, boxes of 64
// columns x 128 rows x 1 head (tma_map.cuh)
int make_map(CUtensorMap* map, const void* base, int D, int rows, int heads) {
  return tma_map::make_3d(map, base, 2, D, rows, heads, 64, 128);
}

template <int DN>
int launch_tma(const void* q, const void* k, const void* v, void* o, int* counter, int N, int Hq,
               int Hkv, int Sq, int Skv, int D, float scale, int causal, int window,
               cudaStream_t stream) {
  using C = tma::Cfg<DN>;
  const int nqb = (Sq + tma::BQ - 1) / tma::BQ, nbh = N * Hq;
  if ((long long)nqb * nbh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int sms = tc::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // a section: the q heads of as many kv heads as SECTION_BYTES of K and V
  // hold (at least one)
  const long kv_heads = tma::SECTION_BYTES / (4L * Skv * D);
  const long hs_want = (kv_heads > 0 ? kv_heads : 1) * (Hq / Hkv);
  const int hs = hs_want < nbh ? (int)hs_want : nbh;
  if (counter == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = tma::fa_bf16_tma_kernel<DN>;
  // once an instantiation (the process's device, as sm_count): the
  // shared-memory opt-in, and setmaxnreg's check.  setmaxnreg moves
  // registers between the warpgroups within the block's allocation:
  // unless it holds the raised total, a consumer's raise waits forever
  static const int ready = [] {
    auto kern = tma::fa_bf16_tma_kernel<DN>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    return fa.numRegs * tma::NT < 128 * (tma::PRODUCER_REGS + 2 * tma::CONSUMER_REGS)
               ? (int)cudaErrorInvalidConfiguration
               : 0;
  }();
  if (ready != 0) return ready;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, D, Sq, N * Hq);
  if (err == 0) err = make_map(&mk, k, D, Skv, N * Hkv);
  if (err == 0) err = make_map(&mv, v, D, Skv, N * Hkv);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nqb * nbh < sms ? nqb * nbh : sms, tma::NT, C::BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), counter, Hq, Hkv, Sq, Skv, D, scale, causal,
      window, nbh, nqb, hs);
  return (int)cudaGetLastError();
}

template <int DN>
int launch_bf16_probe(const void* q, const void* k, const void* p, const void* v, float* s,
                      float* o, int D, cudaStream_t stream) {
  using C = tma::Cfg<DN>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, D, 64, 1);
  if (err == 0) err = make_map(&mk, k, D, 128, 1);
  if (err == 0) err = make_map(&mv, v, D, 128, 1);
  if (err != 0) return err;
  constexpr int bytes = 1024 + 3 * C::TILE + 64;
  auto kernel = tma::bf16_probe_kernel<DN>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, 128, bytes, stream>>>(mq, mk, mv, static_cast<const __nv_bfloat16*>(p), s, o, D);
  return (int)cudaGetLastError();
}

// The routes of flash_attention_launch, decided by shape, type and
// alignment alone before the launch (never a retry of another)
enum Route { kF32Mma = 0, kWide = 1, kBf16CpAsync = 2, kBf16Tma = 3 };

int route_of(const void* q, const void* k, const void* v, const void* o, int D, int dtype) {
  if (D > 128) return D <= wide::MAX_D ? kWide : kF32Mma;
  if (dtype == 0) return kF32Mma;
  // TMA: 16-byte row strides and base addresses
  const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return D % 8 == 0 && a % 16 == 0 ? kBf16Tma : kBf16CpAsync;
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

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o, int N, int Hq, int Hkv,
                int Sq, int Skv, int D, float scale, int causal, int window, cudaStream_t stream) {
  const int cl = (D + wide::DS - 1) / wide::DS;
  const long long bx = (long long)cl * ((Sq + wide::BQ - 1) / wide::BQ);
  if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, int, float, int, int) =
      cl == 2   ? wide::fa_wide_kernel<T, 2>
      : cl == 3 ? wide::fa_wide_kernel<T, 3>
      : cl == 4 ? wide::fa_wide_kernel<T, 4>
      : cl == 5 ? wide::fa_wide_kernel<T, 5>
      : cl == 6 ? wide::fa_wide_kernel<T, 6>
      : cl == 7 ? wide::fa_wide_kernel<T, 7>
                : wide::fa_wide_kernel<T, 8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bx, 1, N * Hq);
  cfg.blockDim = dim3(wide::NT);
  cfg.dynamicSmemBytes = wide::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
                           scale, causal, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q [N, Hq, Sq, D], k/v [N, Hkv, Skv, D], o [N, Hq, Sq, D], contiguous, all
// of one type: dtype 0 = fp32, 1 = bf16.  D % 4 == 0, Hq % Hkv == 0;
// window <= 0 means none.  counter: one int of device scratch, the bf16
// TMA route's unit counter (cleared on the stream before its launch;
// that route refuses a null one, the others never read it).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int* counter, int N, int Hq, int Hkv, int Sq, int Skv, int D,
                                      float scale, int causal, int window, int dtype,
                                      cudaStream_t stream) {
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || D <= 0 ||
      D % 4 != 0 || N * Hq > 65535)
    return (int)cudaErrorInvalidValue;
#define FA(F, ...) F<__VA_ARGS__>(q, k, v, o, N, Hq, Hkv, Sq, Skv, D, scale, causal, window, stream)
  if (dtype == 0) {
    if (D <= 64) return FA(launch_f32, float, 64);
    if (D <= 128) return FA(launch_f32, float, 128);
    if (D <= wide::MAX_D) return FA(launch_wide, float);
    return FA(launch_f32, float, 128);
  }
  if (dtype == 1 && route_of(q, k, v, o, D, dtype) == kBf16Tma) {
#define TMA(DN) launch_tma<DN>(q, k, v, o, counter, N, Hq, Hkv, Sq, Skv, D, scale, causal, window, stream)
    if (D <= 64) return TMA(64);
    if (D <= 80) return TMA(80);
    if (D <= 96) return TMA(96);
    if (D <= 112) return TMA(112);
    return TMA(128);
#undef TMA
  }
  if (dtype == 1) {
    // PR 15's cp.async kernel (d % 8 == 4, or 8-byte-aligned operands):
    // the head dim padded to the MMA's 16
    if (D <= 16) return FA(launch_bf16, 16);
    if (D <= 32) return FA(launch_bf16, 32);
    if (D <= 64) return FA(launch_bf16, 64);
    if (D <= 80) return FA(launch_bf16, 80);
    if (D <= 128) return FA(launch_bf16, 128);
    if (D <= wide::MAX_D) return FA(launch_wide, __nv_bfloat16);
    return FA(launch_f32, __nv_bfloat16, 128);
  }
#undef FA
  return (int)cudaErrorInvalidValue;
}

// The route flash_attention_launch takes for these operands (Route):
// 0 fp32 mma.sync, 1 the wide cluster kernel, 2 bf16 cp.async, 3 bf16 TMA
extern "C" int flash_attention_route(const void* q, const void* k, const void* v, const void* o,
                                     int D, int dtype) {
  return route_of(q, k, v, o, D, dtype);
}

// One q k^T and one P V of the bf16 TMA kernel through its boxes, swizzle
// and operand layouts: q [64, D], k and v [128, D], p [64, 128] bf16 on the
// card, D % 8 == 0 and D <= 128, 16-byte aligned -> s = q k^T [64, 128],
// o = p v [64, D] fp32
extern "C" int flash_bf16_probe_launch(const void* q, const void* k, const void* p, const void* v,
                                       float* s, float* o, int D, cudaStream_t stream) {
  if (D <= 0 || D > 128 || D % 8 != 0) return (int)cudaErrorInvalidValue;
#define PROBE(DN) launch_bf16_probe<DN>(q, k, p, v, s, o, D, stream)
  if (D <= 64) return PROBE(64);
  if (D <= 80) return PROBE(80);
  if (D <= 96) return PROBE(96);
  if (D <= 112) return PROBE(112);
  return PROBE(128);
#undef PROBE
}

// One wgmma of each product of the fp32 wide kernel through its operand
// layouts: p [64, 8], v [8, 128], q [64, 8], k [64, 8] fp32 on the card
// (TF32-exact values) -> o = p v [64, 128], s = q k^T [64, 64]
extern "C" int flash_wide_probe_launch(const float* p, const float* v, const float* q,
                                       const float* k, float* o, float* s, cudaStream_t stream) {
  wide::wide_probe_kernel<<<1, 128, 0, stream>>>(p, v, q, k, o, s);
  return (int)cudaGetLastError();
}
