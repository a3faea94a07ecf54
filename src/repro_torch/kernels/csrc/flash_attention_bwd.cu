// The gradient of flash attention on the H100's tensor cores: given q, k,
// v, the forward's output o and its gradient dO, the gradients dq, dk, dv
// in the inputs' type, FlashAttention-2's backward in three phases with no
// [Sq, Skv] matrix in device memory and no atomic sum.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py's
// flash_attention has no custom_vjp, and JAX trains through the XLA
// reference (ops.flash_attention, impl="xla"), so jax.grad differentiates
// ref.flash_attention_ref.  Added because the port's autograd.Function
// (kernels/flash_attention.py, FlashAttention) would otherwise run its
// plain PyTorch backward on the card.  The masks are the forward's:
// query row i sits at i + Skv - Sq; causal keeps k <= q, a window
// k > q - window; a q head bh reads kv head (bh / Hq) * Hkv + (bh % Hq) /
// (Hq / Hkv).  A row with no key (Sq > Skv, causal) has lse = -inf, P = 0
// and so 0 gradients.
//
// The phases, each a launch on the caller's stream, in this order:
//   1. row statistics, a block per (q head, 128 query rows): lse, the
//      row's log-sum-exp of S * scale (in base 2: lse2 = lse * log2 e)
//      recomputed from Q K^T over the keys its masks leave, and D =
//      rowsum(dO * O); both into fp32 scratch [N * Hq, SqP];
//   2. dK and dV, a block per (kv head, 128 keys, part): for each q head
//      of the kv head's group in order and each 64-row query tile its
//      masks leave, S^T = K Q^T, P^T = 2^(S^T scale log2 e - lse2),
//      dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D) scale,
//      dK += dS^T Q.  dK and dV stay in fp32 registers over the whole
//      group, so the GQA sum runs in one fixed order.  Where the grid
//      would leave SMs idle, the group's tiles are dealt round-robin to
//      `parts` blocks (the wrapper picks parts from the shape and the SM
//      count), each writing fp32 partials;
//   3. dQ, a block per (q head, 128 query rows) over its key tiles of 64:
//      S, P, dP = dO V^T, dS, dQ += dS K, written once;
//   4. the parts summed in order and rounded to the inputs' type.
// Every value is summed by the same threads in the same order whatever
// the launch, so two calls give the same bits.
//
// bf16 (d % 8 == 0, d <= 128, 16-byte-aligned operands; every training
// call): every product on wgmma with fp32 accumulators.  One thread loads
// the tiles by TMA (3-D maps: head dim, position, head; boxes of 64 x 64
// in the 128-byte swizzle, hopper_mma.cuh), rows past Sq or Skv and
// columns past d arriving as zeros, into rings of full mbarriers; the
// head dim is padded to DP = 64, 80 or 128.  One layout serves both roles
// of a [rows, d] tile: K-major (the head dim deepest: S = Q K^T, S^T = K
// Q^T, dP = dO V^T, dP^T = V dO^T, as m64n64k16 with both operands in
// shared memory) and MN-major (the rows deepest: dV += P^T dO, dK += dS^T
// Q, dQ += dS K, as m64nDPk16 with P or dS from registers, rounded to
// bf16: the accumulator fragment of S is the A fragment of P).
// bwd_probe_kernel runs each form once on exact inputs.  The masks are
// applied only on tiles that cross the causal diagonal, the window's
// edge, Sq or Skv (a template flag: evaluated on every element they cost
// as much as the rest of the element-wise work).  The two warpgroups of a
// block take the tensor cores in turns.
//
// fp32 (d % 4 == 0, d <= 128): the same phases in 3xTF32 on mma.sync
// (hi = tf32(x), lo = tf32(x - hi); lo*hi + hi*lo + hi*hi in chains of
// four k-steps, each chain added to its sum with round-to-nearest), a
// block of four warps of 16 rows (query rows, or keys in phase 2), tiles
// of 64, P and dS passed through a warp's shared memory as A operands.
//
// Bound on the H100: operations.  A kept (query, key) pair costs 2 d FLOPs
// in each of eight products (one in phase 1, four in phase 2, three in
// phase 3) against 2.5x the forward's 4 d for the five products of the
// gradient itself: the bound counted by chip_smoke.py is those five at
// 989 TFLOP/s (bf16).  Causal load imbalance in phase 2 (key block 0 sees
// every query tile, the last few) is met by the longest blocks first and
// by the parts.

#include <cuda.h>                       // CUtensorMap and its enums (no -lcuda)
#include <cuda_runtime.h>

#include "attn_common.cuh"
#include "hopper_mma.cuh"
#include "tma_map.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int QT = 64;          // query rows a tile (phase 2)
constexpr int KT = 64;          // keys a tile (phases 1 and 3)
constexpr int SQ_ALIGN = 128;   // rows of a q head in the statistics' scratch: Sq rounded up

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's masks, positions aligned at the sequence end
struct Mask {
  int Sq, Skv, off, causal, window;
  __device__ __forceinline__ bool keep(int qi, int kj) const {
    const int qp = qi + off;
    return qi < Sq && kj < Skv && (!causal || kj <= qp) && (window <= 0 || kj > qp - window);
  }
  // whether every pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is kept
  __device__ __forceinline__ bool all(int q0, int nq, int k0, int nk) const {
    return q0 + nq <= Sq && k0 + nk <= Skv && (!causal || k0 + nk - 1 <= q0 + off) &&
           (window <= 0 || k0 > q0 + nq - 1 + off - window);
  }
};

// The keys [lo, hi) that any of the query rows [q0, q0 + nq) sees, lo
// rounded down to a tile of `tile`; and the tiles
struct KeyRange {
  int lo, ntiles;
};

__device__ __forceinline__ KeyRange key_range(const Mask& m, int q0, int nq, int tile) {
  const int lo = m.window > 0 ? max(0, q0 + m.off - m.window + 1) / tile * tile : 0;
  const int hi = m.causal ? min(m.Skv, min(q0 + nq, m.Sq) + m.off) : m.Skv;
  return {lo, hi > lo ? (hi - lo + tile - 1) / tile : 0};
}

// The query tiles of QT rows that any key of [k0, k0 + nk) is seen by:
// [t0, t0 + n)
struct QueryRange {
  int t0, n;
};

__device__ __forceinline__ QueryRange query_range(const Mask& m, int k0, int nk) {
  const int kmax = min(k0 + nk, m.Skv) - 1;
  const int lo = m.causal ? max(0, k0 - m.off) : 0;
  const int hi = m.window > 0 ? min(m.Sq, kmax + m.window - m.off) : m.Sq;
  if (hi <= lo) return {0, 0};
  return {lo / QT, (hi + QT - 1) / QT - lo / QT};
}

// Phase 2's block u: kv heads fastest, then parts, then key blocks from
// the first (under a causal mask the longest) on
struct KvUnit {
  int nh, part, kb;
};

__device__ __forceinline__ KvUnit kv_unit(int u, int nh, int parts) {
  KvUnit w;
  w.nh = u % nh;
  u /= nh;
  w.part = u % parts;
  w.kb = u / parts;
  return w;
}

// ===========================================================================
// bf16: wgmma
// ===========================================================================

namespace bf {

constexpr int NT = 256;         // two warpgroups
constexpr int RB = 128;         // query rows a block (phases 1 and 3): 64 a warpgroup
constexpr int KB = 128;         // keys a block (phase 2): 64 a warpgroup
constexpr int BOX_ROWS = 64;    // rows of a TMA box (64 columns, 128 bytes a row)

// Stages of the TMA rings: phase 1's K tiles (two blocks an SM), phase 3's
// K and V tiles, phase 2's Q and dO tiles
constexpr int STATS_NS = 4, ROWS_NS = 3, KV_NS = 3;

// Shared-memory offsets of the phases, from a 1024-aligned base.  A tile
// of R rows x DP columns is NB boxes of 64 columns, each R rows of 128
// bytes in the 128-byte swizzle, as TMA writes them: R * ROW bytes.
template <int DP>
struct Cfg {
  static_assert(DP % 16 == 0 && DP <= 128, "the instantiated head dims");
  static constexpr int NB = (DP + 63) / 64;
  static constexpr int ROW = NB * 128;
  // phases 1 and 3: Q and dO of the block's rows, the stages of a K and a V tile
  static constexpr int R_DO = RB * ROW;
  static constexpr int R_K = 2 * RB * ROW;
  static constexpr int R_V = R_K + ROWS_NS * KT * ROW;
  static constexpr int R_BAR = R_V + ROWS_NS * KT * ROW;
  static constexpr int STATS_K = R_DO;                              // phase 1: Q, then K tiles
  static constexpr int STATS_BAR = STATS_K + STATS_NS * KT * ROW;
  // phase 2: the block's K and V, the stages of a Q tile, a dO tile and their lse2 and D
  static constexpr int K_Q = 2 * KB * ROW;
  static constexpr int K_DO = K_Q + KV_NS * QT * ROW;
  static constexpr int K_STAT = K_DO + KV_NS * QT * ROW;
  static constexpr int K_BAR = K_STAT + KV_NS * 2 * QT * 4;
  // each: 1024 to align the base, 8 mbarriers after the tiles
  static constexpr int R_BYTES = 1024 + R_BAR + 64;
  static constexpr int STATS_BYTES = 1024 + STATS_BAR + 64;
  static constexpr int K_BYTES = 1024 + K_BAR + 64;
};

// the dynamic shared memory's first 1024-aligned byte: a swizzle atom's
// pattern follows the address bits, so every box starts 1024-aligned
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (tc::smem_u32(p) & 1023u)) & 1023u);
}

// rows [row0, row0 + R) of head `head` of a 3-D map (head dim, rows,
// heads; boxes of 64 x 64) into a tile of R rows at dst, completing on
// `bar`; rows and columns outside the tensor arrive as zeros.  One thread.
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, int R,
                                         int row0, int head, uint64_t* bar) {
  for (int h = 0; h < R / BOX_ROWS; ++h)
#pragma unroll
    for (int b = 0; b < Cfg<DP>::NB; ++b)
      tc::tma_load_3d(dst + b * R * 128 + h * BOX_ROWS * 128, map, 64 * b, row0 + h * BOX_ROWS,
                      head, bar);
}

// S [64 x 64] = A B^T over DP / 16 steps of the head dim: A's 64 rows at
// `a` and B's 64 rows at `b`, both K-major in swizzled tiles whose boxes
// are a_box and b_box bytes apart; step ks reads 32 bytes on within box
// ks / 4.  One commit group.
template <int DP>
__device__ __forceinline__ void issue_ss(float* s, const unsigned char* a, int a_box,
                                         const unsigned char* b, int b_box) {
  tc::fence_regs<32>(s);
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    tc::wgmma_m64n64k16_ss(s, tc::make_desc_sw128(a + (ks >> 2) * a_box + (ks & 3) * 32, 16, 1024),
                           tc::make_desc_sw128(b + (ks >> 2) * b_box + (ks & 3) * 32, 16, 1024),
                           ks > 0);
  tc::wgmma_commit();
}

// acc [64 x DP] += P [64 x 64] B [64 x DP]: P from registers (step j's A
// fragment at pa + 4 j, keys or queries 16 j .. 16 j + 15), B's 64 rows
// MN-major (the rows deepest) in a swizzled tile of 64-row boxes (8 KB
// apart): m64nDPk16, 16 rows (2,048 bytes) a step.  One commit group.
template <int DP>
__device__ __forceinline__ void issue_rs(float* acc, uint32_t* pa, const unsigned char* b) {
  tc::fence_regs<16>(pa);
  tc::fence_regs<DP / 2>(acc);
  tc::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    tc::wgmma_pv_bf16<DP>(acc, pa + 4 * j, tc::make_desc_sw128(b + j * 2048, 64 * 128, 1024), 1);
  tc::wgmma_commit();
}

// a [64 x 64] accumulator fragment rounded to bf16 (nearest-even) as the
// A fragments of a product over its columns
__device__ __forceinline__ void pack(uint32_t* pa, const float* s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = attn::pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

__device__ __forceinline__ void wait_all() {
  tc::wgmma_wait<0>();
}

// The two warpgroups issue their products in turns (named barriers 1 and
// 2, warpgroup 0 first: warpgroup 1 arrives once before its loop), so one
// warpgroup's softmax runs under the other's products rather than beside
// them
__device__ __forceinline__ void turn_take(int wg) { tc::named_bar_sync(1 + wg, 256); }
__device__ __forceinline__ void turn_give(int wg) { tc::named_bar_arrive(2 - wg, 256); }

// The element-wise work of a tile, for the thread's accumulator fragment
// (s[4 c + e] at row r + 8 (e >> 1), column kv0 + 8 c + 2 t + (e & 1)),
// with the masks only where a tile needs them (MASKED: the tile crosses
// the causal diagonal, the window's edge, Sq or Skv).
//
// Phase 1: the rows' online log-sum-exp of s * scale2 (base 2), m and l
// as softmax_tile keeps them in the forward.
template <bool MASKED>
__device__ __forceinline__ void stats_tile(float* s, float* m, float* l, const Mask& mk, int r,
                                           int kv0, int t, float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float x = s[i] * scale2;
    if (MASKED && !mk.keep(r + 8 * h, kv0 + 8 * (i >> 2) + 2 * t + (i & 1))) x = -INFINITY;
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    // no key kept yet: exponentiate against 0, so every term is 2^-inf = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    l[h] *= ex2(m[h] - m_use);
    m[h] = m_new;
    mx[h] = m_use;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) rs[(i >> 1) & 1] += ex2(s[i] - mx[(i >> 1) & 1]);
  l[0] += rs[0];
  l[1] += rs[1];
}

// Phase 3 (rows r, r + 8, keys across): P = 2^(s scale2 - lse2), 0 where
// masked; dS = P (dP - D) scale, into dp.
template <bool MASKED>
__device__ __forceinline__ void ds_rows(const float* s, float* dp, const float* L, const float* Dr,
                                        const Mask& mk, int r, int kv0, int t, float scale2,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale2, -L[h]));
    if (MASKED && !mk.keep(r + 8 * h, kv0 + 8 * (i >> 2) + 2 * t + (i & 1))) p = 0.f;
    dp[i] = p * (dp[i] - Dr[h]) * scale;
  }
}

// Phase 2 (keys kr, kr + 8 down, queries q0 + 8 c + 2 t (+1) across, their
// lse2 and D in shared memory): P^T into s, dS^T into dp.
template <bool MASKED>
__device__ __forceinline__ void ds_cols(float* s, float* dp, const float* Lt, const float* Dt,
                                        const Mask& mk, int q0, int kr, int t, float scale2,
                                        float scale) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 lq = *reinterpret_cast<const float2*>(Lt + 8 * c + 2 * t);
    const float2 dq = *reinterpret_cast<const float2*>(Dt + 8 * c + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      float p = ex2(fmaf(s[i], scale2, -((e & 1) ? lq.y : lq.x)));
      if (MASKED && !mk.keep(q0 + 8 * c + 2 * t + (e & 1), kr + 8 * (e >> 1))) p = 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - ((e & 1) ? dq.y : dq.x)) * scale;
    }
  }
}

// Phases 1 (STATS) and 3.  Warpgroup wg owns rows q0 + 64 wg .. + 63; the
// thread rows r and r + 8 (r = q0 + 64 wg + 16 w + g) and, of each 8-key
// chunk c of a tile, keys 8 c + 2 t and 8 c + 2 t + 1.  Thread 0 loads the
// block's Q (and dO) once and the K (and V) tiles by TMA into a ring of NS
// stages, a full barrier a stage; a stage is reloaded after the block
// barrier that ends its tile.
template <int DP, bool STATS>
__global__ void __launch_bounds__(NT, STATS ? 2 : 1)
bwd_rows_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk_, const __grid_constant__ CUtensorMap mv,
                const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ lse2, float* __restrict__ dd, __nv_bfloat16* __restrict__ dq,
                int Hq, int Hkv, int Sq, int Skv, int SqP, int D, float scale, int causal,
                int window, int nbh) {
  using C = Cfg<DP>;
  constexpr int NS = STATS ? STATS_NS : ROWS_NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const Qs = smem;
  unsigned char* const dOs = smem + C::R_DO;
  unsigned char* const Ks = smem + (STATS ? C::STATS_K : C::R_K);
  unsigned char* const Vs = smem + C::R_V;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + (STATS ? C::STATS_BAR : C::R_BAR));
  uint64_t* const full_q = full + NS;

  const int bh = blockIdx.x % nbh;
  const int q0 = ((Sq + RB - 1) / RB - 1 - blockIdx.x / nbh) * RB;   // longest causal rows first
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const Mask mk{Sq, Skv, Skv - Sq, causal, window};
  const KeyRange kr = key_range(mk, q0, RB, KT);
  const __nv_bfloat16* dO = dout + (size_t)bh * Sq * D;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + 64 * wg;               // this warpgroup's first row
  const int r = qw + 16 * w + g;             // the thread's rows r, r + 8
  const float scale2 = scale * LOG2E;
  constexpr int KV_BYTES = (STATS ? 1 : 2) * KT * C::ROW;

  auto load_tile = [&](int it) {             // thread 0: tile it into stage it % NS
    const int st = it % NS, kv0 = kr.lo + it * KT;
    tc::mbar_arrive_expect_tx(&full[st], KV_BYTES);
    tma_tile<DP>(Ks + st * KT * C::ROW, &mk_, KT, kv0, kvh, &full[st]);
    if (!STATS) tma_tile<DP>(Vs + st * KT * C::ROW, &mv, KT, kv0, kvh, &full[st]);
  };
  if (tid == 0) {
    for (int i = 0; i <= NS; ++i) tc::mbar_init(&full[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(full_q, (STATS ? 1 : 2) * RB * C::ROW);
    tma_tile<DP>(Qs, &mq, RB, q0, bh, full_q);
    if (!STATS) tma_tile<DP>(dOs, &mdo, RB, q0, bh, full_q);
    for (int it = 0; it < NS - 1 && it < kr.ntiles; ++it) load_tile(it);
  }

  if (STATS) {
    // D = rowsum(dO * O): two threads a row, 8-column chunks dealt in
    // turn (all loads issued first), the halves added once
    const int row = q0 + tid / 2;
    const __nv_bfloat16* a = dO + (size_t)row * D;
    const __nv_bfloat16* b = o + (size_t)bh * Sq * D + (size_t)row * D;
    constexpr int NCH = DP / 16;
    uint4 x[NCH], y[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = 8 * (tid % 2) + 16 * i;
      const bool ok = row < Sq && c < D;
      x[i] = ok ? *reinterpret_cast<const uint4*>(a + c) : make_uint4(0u, 0u, 0u, 0u);
      y[i] = ok ? *reinterpret_cast<const uint4*>(b + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const uint32_t xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w}, ys[4] = {y[i].x, y[i].y, y[i].z, y[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc = fmaf(__uint_as_float(xs[j] << 16), __uint_as_float(ys[j] << 16), acc);
        acc = fmaf(__uint_as_float(xs[j] & 0xffff0000u), __uint_as_float(ys[j] & 0xffff0000u), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0 && q0 + tid / 2 < SqP) dd[(size_t)bh * SqP + q0 + tid / 2] = acc;
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};   // phase 1
  float L[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};              // phase 3: lse2 and D of rows r, r + 8
  if (!STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      L[h] = lse2[(size_t)bh * SqP + r + 8 * h];
      Dr[h] = dd[(size_t)bh * SqP + r + 8 * h];
    }
  }
  float acc[DP / 2], s[32], dp[32];
  uint32_t pds[16];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pds[i] = 0u;

  tc::mbar_wait(full_q, 0);                  // (also where no key tile follows: no copy outlives the block)
  if (!STATS && wg == 1) tc::named_bar_arrive(1, 256);
  for (int it = 0; it < kr.ntiles; ++it) {
    const int st = it % NS, kv0 = kr.lo + it * KT;
    const unsigned char* const Kt = Ks + st * KT * C::ROW;
    const unsigned char* const Vt = Vs + st * KT * C::ROW;
    __syncthreads();                         // tile it - 1 is done: its stage is free
    if (tid == 0 && it + NS - 1 < kr.ntiles) load_tile(it + NS - 1);
    tc::mbar_wait(&full[st], (it / NS) & 1);
    if (!STATS) turn_take(wg);
    issue_ss<DP>(s, Qs + wg * 64 * 128, RB * 128, Kt, KT * 128);
    if (!STATS) {
      issue_ss<DP>(dp, dOs + wg * 64 * 128, RB * 128, Vt, KT * 128);
      turn_give(wg);
    }
    wait_all();
    tc::fence_regs<32>(s);
    tc::fence_regs<32>(dp);
    const bool full_tile = mk.all(qw, 64, kv0, KT);
    if (STATS) {
      if (full_tile)
        stats_tile<false>(s, m, l, mk, r, kv0, t, scale2);
      else
        stats_tile<true>(s, m, l, mk, r, kv0, t, scale2);
    } else {
      if (full_tile)
        ds_rows<false>(s, dp, L, Dr, mk, r, kv0, t, scale2, scale);
      else
        ds_rows<true>(s, dp, L, Dr, mk, r, kv0, t, scale2, scale);
      pack(pds, dp);
      turn_take(wg);
      issue_rs<DP>(acc, pds, Kt);            // dQ += dS K
      turn_give(wg);
      wait_all();
      tc::fence_regs<DP / 2>(acc);
      tc::fence_regs<16>(pds);
    }
  }

  if (STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r + 8 * h;
      // rows past Sq: +inf, so P is 0 there without a mask
      const float x = row >= Sq ? INFINITY : l[h] > 0.f ? m[h] + log2f(l[h]) : -INFINITY;
      if (t == 0 && row < SqP) lse2[(size_t)bh * SqP + row] = x;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= Sq) continue;
      __nv_bfloat16* out = dq + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) = attn::pack_bf16x2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
    }
  }
}

// Phase 2.  Warpgroup wg owns keys k0 + 64 wg .. + 63; the thread keys kr,
// kr + 8 (kr = k0 + 64 wg + 16 w + g) and, of each 8-row chunk c of a query
// tile, rows 8 c + 2 t and 8 c + 2 t + 1.  Thread 0 loads the block's K and
// V once and the part's Q and dO tiles by TMA into a ring of KV_NS stages;
// threads 0-31 copy each tile's lse2 and D by cp.async.  Writes this
// part's fp32 dK and dV ([N * Hkv, Skv, D] each, dV after dK) at dkv.
template <int DP>
__global__ void __launch_bounds__(NT, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap mk_, const __grid_constant__ CUtensorMap mv,
                const float* __restrict__ lse2, const float* __restrict__ dd,
                float* __restrict__ dkv, int N, int Hq, int Hkv, int Sq, int Skv, int SqP, int D,
                float scale, int causal, int window, int parts) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const Ks = smem;
  unsigned char* const Vs = smem + KB * C::ROW;
  unsigned char* const Qs = smem + C::K_Q;      // stage st at st * QT * ROW
  unsigned char* const dOs = smem + C::K_DO;
  float* const stat = reinterpret_cast<float*>(smem + C::K_STAT);   // stage st: lse2 [64], D [64]
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + C::K_BAR);
  uint64_t* const full_kv = full + KV_NS;

  const int nh = N * Hkv, rep = Hq / Hkv;
  const KvUnit u = kv_unit(blockIdx.x, nh, parts);
  const int seq = u.nh / Hkv, kvh = u.nh % Hkv, k0 = u.kb * KB;
  const Mask mk{Sq, Skv, Skv - Sq, causal, window};
  const QueryRange qr = query_range(mk, k0, KB);
  const int total = rep * qr.n;                  // the group's tiles, head by head
  const int mine = total > u.part ? (total - u.part + parts - 1) / parts : 0;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + 64 * wg;                   // this warpgroup's first key
  const int kr = kw + 16 * w + g;                // the thread's keys kr, kr + 8
  const float scale2 = scale * LOG2E;

  // the tile i of this part: q head and first row
  auto tile = [&](int i, int& bh, int& q0) {
    const int idx = u.part + i * parts;
    bh = seq * Hq + kvh * rep + idx / qr.n;
    q0 = (qr.t0 + idx % qr.n) * QT;
  };
  auto load_tile = [&](int i) {                  // Q, dO by thread 0; lse2, D by threads 0-31
    const int st = i % KV_NS;
    int bh, q0;
    tile(i, bh, q0);
    if (tid == 0) {
      tc::mbar_arrive_expect_tx(&full[st], 2 * QT * C::ROW);
      tma_tile<DP>(Qs + st * QT * C::ROW, &mq, QT, q0, bh, &full[st]);
      tma_tile<DP>(dOs + st * QT * C::ROW, &mdo, QT, q0, bh, &full[st]);
    }
    if (tid < 32) {                              // 16 chunks of lse2, 16 of D
      const float* src = (tid < 16 ? lse2 : dd) + (size_t)bh * SqP + q0 + 4 * (tid % 16);
      tc::cp_async16(stat + st * 2 * QT + (tid < 16 ? 0 : QT) + 4 * (tid % 16), src, true);
    }
  };

  if (tid == 0) {
    for (int i = 0; i <= KV_NS; ++i) tc::mbar_init(&full[i], 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(full_kv, 2 * KB * C::ROW);
    tma_tile<DP>(Ks, &mk_, KB, k0, u.nh, full_kv);
    tma_tile<DP>(Vs, &mv, KB, k0, u.nh, full_kv);
  }
  // tiles 0 .. KV_NS - 2 now, each its own cp.async group; tile
  // i + KV_NS - 1 at step i
#pragma unroll
  for (int i = 0; i < KV_NS - 1; ++i) {
    if (i < mine) load_tile(i);
    tc::cp_async_commit();
  }

  float dk[DP / 2], dv[DP / 2], s[32], dp[32];
  uint32_t pa[16], pds[16];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  tc::mbar_wait(full_kv, 0);                 // (also where no tile follows: no copy outlives the block)
  if (wg == 1) tc::named_bar_arrive(1, 256);
  for (int i = 0; i < mine; ++i) {
    const int st = i % KV_NS;
    int bh, q0;
    tile(i, bh, q0);
    const unsigned char* const Qt = Qs + st * QT * C::ROW;
    const unsigned char* const dOt = dOs + st * QT * C::ROW;
    const float* const Lt = stat + st * 2 * QT;
    const float* const Dt = Lt + QT;
    tc::cp_async_wait<KV_NS - 2>();              // this thread's lse2 and D of tile i
    __syncthreads();                             // everyone's; and tile i - 1 is done
    if (i + KV_NS - 1 < mine) load_tile(i + KV_NS - 1);
    tc::cp_async_commit();
    tc::mbar_wait(&full[st], (i / KV_NS) & 1);
    turn_take(wg);
    issue_ss<DP>(s, Ks + wg * 64 * 128, KB * 128, Qt, QT * 128);     // S^T = K Q^T
    issue_ss<DP>(dp, Vs + wg * 64 * 128, KB * 128, dOt, QT * 128);   // dP^T = V dO^T
    turn_give(wg);
    wait_all();
    tc::fence_regs<32>(s);
    tc::fence_regs<32>(dp);
    if (mk.all(q0, QT, kw, 64))
      ds_cols<false>(s, dp, Lt, Dt, mk, q0, kr, t, scale2, scale);
    else
      ds_cols<true>(s, dp, Lt, Dt, mk, q0, kr, t, scale2, scale);
    pack(pa, s);
    pack(pds, dp);
    turn_take(wg);
    issue_rs<DP>(dv, pa, dOt);                   // dV += P^T dO
    issue_rs<DP>(dk, pds, Qt);                   // dK += dS^T Q
    turn_give(wg);
    wait_all();
    tc::fence_regs<DP / 2>(dv);
    tc::fence_regs<DP / 2>(dk);
    tc::fence_regs<16>(pa);
    tc::fence_regs<16>(pds);
  }

  tc::cp_async_wait<0>();
  const size_t n_el = (size_t)nh * Skv * D;
  float* const out_k = dkv + (size_t)u.part * 2 * n_el + (size_t)u.nh * Skv * D;
  float* const out_v = out_k + n_el;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr + 8 * h;
    if (key >= Skv) continue;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < D) {
        *reinterpret_cast<float2*>(out_k + (size_t)key * D + col) = make_float2(dk[4 * c + 2 * h], dk[4 * c + 2 * h + 1]);
        *reinterpret_cast<float2*>(out_v + (size_t)key * D + col) = make_float2(dv[4 * c + 2 * h], dv[4 * c + 2 * h + 1]);
      }
    }
  }
}

// One of each product form through the kernels' TMA boxes, layouts and
// helpers, on exact inputs: s [64 x 64] = a [64 x d] b [64 x d]^T
// (issue_ss: both K-major, the form of S, S^T, dP and dP^T) and o [64 x d]
// = p [64 x 64] c [64 x d] (issue_rs: p from registers in the accumulator
// layout of S, rounded to bf16, c MN-major, the form of dV, dK and dQ).
// One warpgroup, one block.
template <int DP>
__global__ void __launch_bounds__(128)
bwd_probe_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ CUtensorMap mc, const __nv_bfloat16* __restrict__ p,
                 float* __restrict__ s_out, float* __restrict__ o_out, int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  unsigned char* const As = smem;
  unsigned char* const Bs = smem + 64 * Cfg<DP>::ROW;
  unsigned char* const Cs = smem + 2 * 64 * Cfg<DP>::ROW;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem + 3 * 64 * Cfg<DP>::ROW);
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  if (tid == 0) {
    tc::mbar_init(bar, 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tc::mbar_arrive_expect_tx(bar, 3 * 64 * Cfg<DP>::ROW);
    tma_tile<DP>(As, &ma, 64, 0, 0, bar);
    tma_tile<DP>(Bs, &mb, 64, 0, 0, bar);
    tma_tile<DP>(Cs, &mc, 64, 0, 0, bar);
  }
  const int r = 16 * w + g;
  float s[32], acc[DP / 2];
  uint32_t pa[16];
#pragma unroll
  for (int cc = 0; cc < 8; ++cc)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * cc + e] = __bfloat162float(p[(r + 8 * (e >> 1)) * 64 + 8 * cc + 2 * t + (e & 1)]);
  pack(pa, s);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  tc::mbar_wait(bar, 0);
  issue_ss<DP>(s, As, 64 * 128, Bs, 64 * 128);
  issue_rs<DP>(acc, pa, Cs);
  wait_all();
  tc::fence_regs<32>(s);
  tc::fence_regs<DP / 2>(acc);
#pragma unroll
  for (int cc = 0; cc < DP / 8; ++cc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), col = 8 * cc + 2 * t + (e & 1);
      if (cc < 8) s_out[row * 64 + col] = s[4 * cc + e];
      if (col < D) o_out[row * D + col] = acc[4 * cc + e];
    }
}

}  // namespace bf

// ===========================================================================
// fp32: 3xTF32 on mma.sync
// ===========================================================================

namespace f32 {

constexpr int NT = 128;        // four warps of 16 rows (query rows, or keys in phase 2)
constexpr int WS = 68;         // row stride of a warp's P / dS scratch [16 x 64]

template <int DP>
struct Cfg {
  static_assert(DP % 32 == 0 && DP <= 128, "the instantiated head dims");
  static constexpr int LD = DP + 4;     // row stride of a staged tile
  static constexpr int TILE = 64 * LD;
  // floats: four tiles (Q, dO, K, V), the warps' scratch, lse2 and D of a tile
  static constexpr int BYTES = (4 * TILE + 4 * 16 * WS + 2 * 64) * 4;
};

// rows [row0, row0 + 64) of an [nrows, D] fp32 matrix into s (row stride
// LD), columns up to DP; zeros outside
template <int DP>
__device__ __forceinline__ void stage(float* s, const float* src, int row0, int nrows, int D) {
  constexpr int per_row = DP / 4;
  for (int e = threadIdx.x; e < 64 * per_row; e += NT) {
    const int r = e / per_row, c = (e % per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && c < D) x = attn::load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(s + r * Cfg<DP>::LD + c) = x;
  }
}

// c[16 x 8 NF] += A[16 x K] B[K x 8 NF] in 3xTF32, A(m, k) = a[m ar + k ac]
// and B(k, n) = b[k br + n bc] in shared memory, split as they are read;
// each chain of four k-steps in a fresh fragment, added to c with
// round-to-nearest (K % 32 == 0)
template <int NF>
__device__ __forceinline__ void mma3(float (&c)[NF][4], const float* a, int ar, int ac,
                                     const float* b, int br, int bc, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 32) {
    float d[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      const int kq = k0 + kk + t;
      const tc::Split a0 = tc::split_tf32(a[g * ar + kq * ac]),
                      a1 = tc::split_tf32(a[(g + 8) * ar + kq * ac]),
                      a2 = tc::split_tf32(a[g * ar + (kq + 4) * ac]),
                      a3 = tc::split_tf32(a[(g + 8) * ar + (kq + 4) * ac]);
      const uint32_t ah[4] = {a0.hi, a1.hi, a2.hi, a3.hi}, al[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const tc::Split b0 = tc::split_tf32(b[kq * br + (8 * j + g) * bc]),
                        b1 = tc::split_tf32(b[(kq + 4) * br + (8 * j + g) * bc]);
        const uint32_t bh[2] = {b0.hi, b1.hi}, bl[2] = {b0.lo, b1.lo};
        tc::mma_3xtf32_chain(d[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] += d[j][i];
  }
}

template <int NF>
__device__ __forceinline__ void zero(float (&c)[NF][4]) {
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// a warp's [16 x 64] fragment (c[j][e] at row g + 8 (e >> 1), column 8 j +
// 2 t + (e & 1)) into its scratch, for use as an A operand
__device__ __forceinline__ void spill(float* ws, const float (&c)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(ws + g * WS + 8 * j + 2 * t) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(ws + (g + 8) * WS + 8 * j + 2 * t) = make_float2(c[j][2], c[j][3]);
  }
  __syncwarp();
}

// Phases 1 (STATS) and 3: a block of 64 query rows, warp w rows 16 w ..
template <int DP, bool STATS>
__global__ void __launch_bounds__(NT)
bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, float* __restrict__ lse2, float* __restrict__ dd,
                float* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int SqP, int D,
                float scale, int causal, int window, int nbh) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, NF = DP / 8;
  extern __shared__ __align__(16) float fsm[];
  float* const Qs = fsm;
  float* const dOs = Qs + C::TILE;
  float* const Ks = dOs + C::TILE;
  float* const Vs = Ks + C::TILE;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* const Ws = Vs + C::TILE + w * 16 * WS;

  const int bh = blockIdx.x % nbh;
  const int q0 = ((Sq + 63) / 64 - 1 - blockIdx.x / nbh) * 64;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const Mask mk{Sq, Skv, Skv - Sq, causal, window};
  const KeyRange kr = key_range(mk, q0, 64, KT);
  const float* Q = q + (size_t)bh * Sq * D;
  const float* dO = dout + (size_t)bh * Sq * D;
  const float* K = k + (size_t)kvh * Skv * D;
  const float* V = v + (size_t)kvh * Skv * D;
  const int r = q0 + 16 * w + g;             // the thread's rows r, r + 8
  const float scale2 = scale * LOG2E;

  stage<DP>(Qs, Q, q0, Sq, D);
  if (!STATS) stage<DP>(dOs, dO, q0, Sq, D);
  if (STATS) {
    // D = rowsum(dO * O): two threads a row, 4-column chunks in turn
    const int row = q0 + tid / 2;
    float acc = 0.f;
    if (row < Sq) {
      const float* a = dO + (size_t)row * D;
      const float* b = o + (size_t)bh * Sq * D + (size_t)row * D;
      for (int c = 4 * (tid % 2); c < D; c += 8) {
        const float4 x = attn::load4(a + c), y = attn::load4(b + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid % 2 == 0) dd[(size_t)bh * SqP + row] = acc;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float L[2] = {0.f, 0.f}, Dr[2] = {0.f, 0.f};
  if (!STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      L[h] = lse2[(size_t)bh * SqP + r + 8 * h];
      Dr[h] = dd[(size_t)bh * SqP + r + 8 * h];
    }
  }
  float acc[NF][4];
  zero(acc);

  for (int it = 0; it < kr.ntiles; ++it) {
    const int kv0 = kr.lo + it * KT;
    __syncthreads();                         // the last tile is done
    stage<DP>(Ks, K, kv0, Skv, D);
    if (!STATS) stage<DP>(Vs, V, kv0, Skv, D);
    __syncthreads();
    float s[8][4];
    zero(s);
    mma3<8>(s, Qs + 16 * w * LD, LD, 1, Ks, 1, LD, DP);      // S = Q K^T
    const bool full = mk.all(q0 + 16 * w, 16, kv0, KT);
    if (STATS) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale2;
          if (!full && !mk.keep(r + 8 * (e >> 1), kv0 + 8 * j + 2 * t + (e & 1))) x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        l[h] *= ex2(m[h] - m_use);
        m[h] = m_new;
        mx[h] = m_use;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += ex2(s[j][e] - mx[e >> 1]);
      l[0] += rs[0];
      l[1] += rs[1];
    } else {
      float dp[8][4];
      zero(dp);
      mma3<8>(dp, dOs + 16 * w * LD, LD, 1, Vs, 1, LD, DP);   // dP = dO V^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = ex2(fmaf(s[j][e], scale2, -L[h]));
          if (!full && !mk.keep(r + 8 * h, kv0 + 8 * j + 2 * t + (e & 1))) p = 0.f;
          dp[j][e] = p * (dp[j][e] - Dr[h]) * scale;
        }
      spill(Ws, dp);
      mma3<NF>(acc, Ws, WS, 1, Ks, LD, 1, KT);                 // dQ += dS K
    }
  }

  if (STATS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r + 8 * h;
      const float x = row >= Sq ? INFINITY : l[h] > 0.f ? m[h] + log2f(l[h]) : -INFINITY;
      if (t == 0) lse2[(size_t)bh * SqP + row] = x;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= Sq) continue;
      float* out = dq + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < D) *reinterpret_cast<float2*>(out + col) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// Phase 2: a block of 64 keys, warp w keys 16 w ..; the part's fp32 dK
// and dV at dkv, as the bf16 kernel writes them
template <int DP>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse2, const float* __restrict__ dd,
                float* __restrict__ dkv, int N, int Hq, int Hkv, int Sq, int Skv, int SqP, int D,
                float scale, int causal, int window, int parts) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD, NF = DP / 8;
  extern __shared__ __align__(16) float fsm[];
  float* const Ks = fsm;
  float* const Vs = Ks + C::TILE;
  float* const Qs = Vs + C::TILE;
  float* const dOs = Qs + C::TILE;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float* const Ws = dOs + C::TILE + w * 16 * WS;
  float* const Lt = dOs + C::TILE + 4 * 16 * WS;
  float* const Dt = Lt + 64;

  const int nh = N * Hkv, rep = Hq / Hkv;
  const KvUnit u = kv_unit(blockIdx.x, nh, parts);
  const int seq = u.nh / Hkv, kvh = u.nh % Hkv, k0 = u.kb * 64;
  const Mask mk{Sq, Skv, Skv - Sq, causal, window};
  const QueryRange qr = query_range(mk, k0, 64);
  const int total = rep * qr.n;
  const int mine = total > u.part ? (total - u.part + parts - 1) / parts : 0;
  const int kw = k0 + 16 * w;                // this warp's first key
  const int kr = kw + g;                     // the thread's keys kr, kr + 8
  const float scale2 = scale * LOG2E;

  stage<DP>(Ks, k + (size_t)u.nh * Skv * D, k0, Skv, D);
  stage<DP>(Vs, v + (size_t)u.nh * Skv * D, k0, Skv, D);
  float dk[NF][4], dv[NF][4];
  zero(dk);
  zero(dv);

  for (int i = 0; i < mine; ++i) {
    const int idx = u.part + i * parts;
    const int bh = seq * Hq + kvh * rep + idx / qr.n, q0 = (qr.t0 + idx % qr.n) * QT;
    __syncthreads();                         // the last tile is done
    stage<DP>(Qs, q + (size_t)bh * Sq * D, q0, Sq, D);
    stage<DP>(dOs, dout + (size_t)bh * Sq * D, q0, Sq, D);
    if (tid < 64) {
      Lt[tid] = lse2[(size_t)bh * SqP + q0 + tid];
      Dt[tid] = dd[(size_t)bh * SqP + q0 + tid];
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma3<8>(s, Ks + 16 * w * LD, LD, 1, Qs, 1, LD, DP);      // S^T = K Q^T
    mma3<8>(dp, Vs + 16 * w * LD, LD, 1, dOs, 1, LD, DP);    // dP^T = V dO^T
    const bool full = mk.all(q0, QT, kw, 16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float p = ex2(fmaf(s[j][e], scale2, -Lt[qc]));
        if (!full && !mk.keep(q0 + qc, kr + 8 * (e >> 1))) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dt[qc]) * scale;
      }
    spill(Ws, s);
    mma3<NF>(dv, Ws, WS, 1, dOs, LD, 1, QT);                 // dV += P^T dO
    spill(Ws, dp);
    mma3<NF>(dk, Ws, WS, 1, Qs, LD, 1, QT);                  // dK += dS^T Q
  }

  const size_t n_el = (size_t)nh * Skv * D;
  float* const out_k = dkv + (size_t)u.part * 2 * n_el + (size_t)u.nh * Skv * D;
  float* const out_v = out_k + n_el;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kr + 8 * h;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D) {
        *reinterpret_cast<float2*>(out_k + (size_t)key * D + col) = make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
        *reinterpret_cast<float2*>(out_v + (size_t)key * D + col) = make_float2(dv[j][2 * h], dv[j][2 * h + 1]);
      }
    }
  }
}

}  // namespace f32

// Phase 4: dk, dv = the parts' fp32 sums in part order, rounded to T;
// n_el % 4 == 0
template <typename T>
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ dkv, T* __restrict__ dk, T* __restrict__ dv,
                 long long n_el, int parts) {
  const long long n4 = n_el / 4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < 2 * n4; i += (long long)gridDim.x * 256) {
    const int which = i >= n4;               // 0: dk, 1: dv
    const long long j = i - which * n4;
    float4 a = reinterpret_cast<const float4*>(dkv + which * n_el)[j];
    for (int p = 1; p < parts; ++p) {
      const float4 b = reinterpret_cast<const float4*>(dkv + (2LL * p + which) * n_el)[j];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    attn::store4<T>((which ? dv : dk) + 4 * j, a);
  }
}

// ===========================================================================
// launch
// ===========================================================================

template <typename Kern>
int set_smem(Kern kern, int bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_sum(const float* dkv, void* dk, void* dv, long long n_el, int parts, cudaStream_t stream) {
  const long long n4 = 2 * (n_el / 4);
  const int sms = tc::sm_count();
  long long blocks = (n4 + 255) / 256;
  if (sms > 0 && blocks > 8LL * sms) blocks = 8LL * sms;
  sum_parts_kernel<T><<<(int)blocks, 256, 0, stream>>>(dkv, static_cast<T*>(dk), static_cast<T*>(dv),
                                                        n_el, parts);
  return (int)cudaGetLastError();
}

// a 3-D map of a contiguous bf16 [heads, rows, D] tensor, boxes of 64
// columns x 64 rows x 1 head (tma_map.cuh)
int make_map(CUtensorMap* map, const void* base, int D, int rows, int heads) {
  return tma_map::make_3d(map, base, 2, D, rows, heads, 64, bf::BOX_ROWS);
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                void* dq, void* dk, void* dv, float* scratch, int N, int Hq, int Hkv, int Sq, int Skv,
                int D, float scale, int causal, int window, int parts, cudaStream_t stream) {
  using C = bf::Cfg<DP>;
  using B = __nv_bfloat16;
  const int SqP = (Sq + SQ_ALIGN - 1) / SQ_ALIGN * SQ_ALIGN, nbh = N * Hq;
  float* const lse2 = scratch;
  float* const dd = scratch + (size_t)nbh * SqP;
  float* const dkv = dd + (size_t)nbh * SqP;
  const long long rows_blocks = (long long)((Sq + bf::RB - 1) / bf::RB) * nbh;
  const long long kv_blocks = (long long)((Skv + bf::KB - 1) / bf::KB) * parts * N * Hkv;
  if (rows_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // once an instantiation (the process's device): the shared-memory opt-in
  static const int ready = [] {
    int e = set_smem(bf::bwd_rows_kernel<DP, true>, C::STATS_BYTES);
    if (e == 0) e = set_smem(bf::bwd_rows_kernel<DP, false>, C::R_BYTES);
    if (e == 0) e = set_smem(bf::bwd_dkdv_kernel<DP>, C::K_BYTES);
    return e;
  }();
  if (ready != 0) return ready;
  CUtensorMap mq, mdo, mk, mv;
  int err = make_map(&mq, q, D, Sq, nbh);
  if (err == 0) err = make_map(&mdo, dout, D, Sq, nbh);
  if (err == 0) err = make_map(&mk, k, D, Skv, N * Hkv);
  if (err == 0) err = make_map(&mv, v, D, Skv, N * Hkv);
  if (err != 0) return err;
  bf::bwd_rows_kernel<DP, true><<<(int)rows_blocks, bf::NT, C::STATS_BYTES, stream>>>(
      mq, mdo, mk, mv, static_cast<const B*>(o), static_cast<const B*>(dout), lse2, dd, nullptr, Hq,
      Hkv, Sq, Skv, SqP, D, scale, causal, window, nbh);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bf::bwd_dkdv_kernel<DP><<<(int)kv_blocks, bf::NT, C::K_BYTES, stream>>>(
      mq, mdo, mk, mv, lse2, dd, dkv, N, Hq, Hkv, Sq, Skv, SqP, D, scale, causal, window, parts);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  bf::bwd_rows_kernel<DP, false><<<(int)rows_blocks, bf::NT, C::R_BYTES, stream>>>(
      mq, mdo, mk, mv, nullptr, static_cast<const B*>(dout), lse2, dd, static_cast<B*>(dq), Hq, Hkv,
      Sq, Skv, SqP, D, scale, causal, window, nbh);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return launch_sum<B>(dkv, dk, dv, (long long)N * Hkv * Skv * D, parts, stream);
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const void* dout,
               void* dq, void* dk, void* dv, float* scratch, int N, int Hq, int Hkv, int Sq, int Skv,
               int D, float scale, int causal, int window, int parts, cudaStream_t stream) {
  using C = f32::Cfg<DP>;
  const int SqP = (Sq + SQ_ALIGN - 1) / SQ_ALIGN * SQ_ALIGN, nbh = N * Hq;
  float* const lse2 = scratch;
  float* const dd = scratch + (size_t)nbh * SqP;
  float* const dkv = dd + (size_t)nbh * SqP;
  const long long rows_blocks = (long long)((Sq + 63) / 64) * nbh;
  const long long kv_blocks = (long long)((Skv + 63) / 64) * parts * N * Hkv;
  if (rows_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  int err = set_smem(f32::bwd_rows_kernel<DP, true>, C::BYTES);
  if (err == 0) err = set_smem(f32::bwd_rows_kernel<DP, false>, C::BYTES);
  if (err == 0) err = set_smem(f32::bwd_dkdv_kernel<DP>, C::BYTES);
  if (err != 0) return err;
  f32::bwd_rows_kernel<DP, true><<<(int)rows_blocks, f32::NT, C::BYTES, stream>>>(
      qf, kf, vf, static_cast<const float*>(o), dof, lse2, dd, nullptr, Hq, Hkv, Sq, Skv, SqP, D,
      scale, causal, window, nbh);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  f32::bwd_dkdv_kernel<DP><<<(int)kv_blocks, f32::NT, C::BYTES, stream>>>(
      qf, kf, vf, dof, lse2, dd, dkv, N, Hq, Hkv, Sq, Skv, SqP, D, scale, causal, window, parts);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  f32::bwd_rows_kernel<DP, false><<<(int)rows_blocks, f32::NT, C::BYTES, stream>>>(
      qf, kf, vf, nullptr, dof, lse2, dd, static_cast<float*>(dq), Hq, Hkv, Sq, Skv, SqP, D, scale,
      causal, window, nbh);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  return launch_sum<float>(dkv, dk, dv, (long long)N * Hkv * Skv * D, parts, stream);
}

template <int DP>
int launch_probe(const void* a, const void* b, const void* p, const void* c, float* s, float* o,
                 int D, cudaStream_t stream) {
  using B = __nv_bfloat16;
  constexpr int bytes = 1024 + 3 * 64 * bf::Cfg<DP>::ROW + 64;
  CUtensorMap ma, mb, mc;
  int err = make_map(&ma, a, D, 64, 1);
  if (err == 0) err = make_map(&mb, b, D, 64, 1);
  if (err == 0) err = make_map(&mc, c, D, 64, 1);
  if (err == 0) err = set_smem(bf::bwd_probe_kernel<DP>, bytes);
  if (err != 0) return err;
  bf::bwd_probe_kernel<DP><<<1, 128, bytes, stream>>>(ma, mb, mc, static_cast<const B*>(p), s, o, D);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [N, Hq, Sq, D]; k, v, dk, dv [N, Hkv, Skv, D]; contiguous,
// all of one type: dtype 0 = fp32 (D % 4 == 0), 1 = bf16 (D % 8 == 0);
// D <= 128, every pointer 16-byte aligned; window <= 0 means none.
// scratch: fp32, 2 N Hq SqP + 2 parts N Hkv Skv D floats (SqP = Sq rounded
// up to 128): lse2 and D of every row, then the parts' dK and dV.  parts
// >= 1 blocks share each key block's tiles (the wrapper picks it).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, float* scratch, int N, int Hq, int Hkv, int Sq,
                                          int Skv, int D, float scale, int causal, int window,
                                          int parts, int dtype, cudaStream_t stream) {
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 128 ||
      parts < 1 || (dtype == 0 && D % 4 != 0) || (dtype == 1 && D % 8 != 0) || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                      reinterpret_cast<uintptr_t>(scratch);
  if (a % 16 != 0) return (int)cudaErrorMisalignedAddress;
#define BWD(F, DP) F<DP>(q, k, v, o, dout, dq, dk, dv, scratch, N, Hq, Hkv, Sq, Skv, D, scale, causal, window, parts, stream)
  if (dtype == 1) {
    if (D <= 64) return BWD(launch_bf16, 64);
    if (D <= 80) return BWD(launch_bf16, 80);
    return BWD(launch_bf16, 128);
  }
  if (D <= 64) return BWD(launch_f32, 64);
  return BWD(launch_f32, 128);
#undef BWD
}

// One of each product form of the bf16 kernels through their layouts: a,
// b, c [64, D], p [64, 64] bf16 on the card, D % 8 == 0 and D <= 128,
// 16-byte aligned -> s = a b^T [64, 64], o = p c [64, D] fp32
extern "C" int flash_bwd_probe_launch(const void* a, const void* b, const void* p, const void* c,
                                      float* s, float* o, int D, cudaStream_t stream) {
  if (D <= 0 || D > 128 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  if (D <= 64) return launch_probe<64>(a, b, p, c, s, o, D, stream);
  if (D <= 80) return launch_probe<80>(a, b, p, c, s, o, D, stream);
  return launch_probe<128>(a, b, p, c, s, o, D, stream);
}
