// Single-token decode attention against a KV cache, grouped-query heads:
// out[b, h] = softmax(q[b, h] . k[b, g, :len] * scale) v[b, g, :len] with
// g = h / rep, rep = Hq / Hkv.  fp32 or bf16 inputs, fp32 softmax and
// accumulation, output in the input type.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (_dec_kernel), the LM serving step's attention.  A sequence of length 0
// gives 0 (ROADMAP C 2: the Pallas kernel gives the mean of v there, its
// plain JAX version NaN).
//
// Bound on the H100: bytes.  Each valid cache row is read once for all rep
// q heads of its kv head; 4 * rep * d FLOPs per row of 2 * d elements.  The
// (sequence, kv head) pairs are few (16 for Qwen2-7B at batch 4, 32 at 8 kv
// heads, against 132 SMs), so each pair's rows are split over a thread
// block cluster, and one launch does the whole call, with no partials in
// global memory and no atomics:
//
// - Partition.  CTA r of a cluster of cl CTAs (8; 4 when rep is 1, whose
//   many kv heads fill the card) takes rows [r * span, (r + 1) * span) below
//   the length, span = ceil(len / cl) rounded up to SPAN_ROUND.  Inside the
//   CTA, stage i holds rows [i * tr, (i + 1) * tr) of its span, and consumer
//   warp w (of cw: 4, or 8 for the CUDA-core p v of grouped heads) takes
//   rows [w * wr, (w + 1) * wr) of each stage.  All of this depends on the
//   length, d, rep and the dtype alone, so a sequence's bits do not depend
//   on the batch, on S or on the other sequences' lengths.
// - A ring per CTA, fed by TMA.  One thread of a producer warp loads each
//   stage's K and V rows (3-D tensor maps over [N * Hkv, S, d], boxes of
//   128-byte rows in the 128-byte swizzle; columns past d arrive as zeros),
//   a box of the stage's tr rows a column box, into a ring of `stages`
//   slots, signalling full barriers, and reuses a slot once the consumer
//   warps have freed it on its empty barrier.  A TMA instruction costs the
//   thread that starts it about the same whatever its box, so whole stages
//   go as one box a column box.  A stage the length cuts loads only the boxes of
//   16 rows that hold rows below it (at most 15 rows past the length a
//   CTA).  Rows past the length may hold anything, NaN included: their
//   scores are replaced by -inf (p = 0) and, on the tensor cores, their V
//   values are zeroed in the fragment before the product, so nothing past
//   the length reaches a sum.
// - The ring is sized from (d, dtype, rep): 96 KB at rep > 1, so that two
//   CTAs share an SM (three stages at bf16 d 128), 48 KB at rep 1 (four).
// - Each consumer warp keeps its own online softmax (m, l) per head and its
//   sums, in fp32, in base 2 (scores times scale * log2(e), p = 2^(s - m)
//   by ex2.approx).  Scores: bf16 q k^T on mma.sync m16n8k16 (up to 8 q
//   heads in rows 0-7 of A, the rows as B through ldmatrix; exact products,
//   fp32 sums), fp32 on the CUDA cores in the mma's accumulator layout.
//   p v: for bf16 with rep > 1 and a head dim that is a multiple of 16 up
//   to 128 (Qwen2-7B's and mixtral's 128, kimi-k2's 112), instantiated per
//   head dim, on mma.sync too: p (fp32, the scores' accumulator reused as
//   the A fragment) split exactly into three bf16 parts, hi and lo in rows
//   0-7 and 8-15 of one product's A and lo2 in rows 0-7 of a second, so
//   every row of the product is used, V through ldmatrix.trans; otherwise
//   (rep 1, fp32, other head dims) on the CUDA cores in fp32, each lane
//   holding up to 8 heads' sums of a 16-byte column chunk, p from the
//   warp's buffer in shared memory.  p is never rounded to bf16; bf16
//   inputs widen exactly.
// - Merge.  The consumer warps' parts merge inside the CTA first, in warp
//   order; then the CTA's one part (m, l, sums) goes, as it is, to the CTA
//   of the cluster that owns each slice of the heads x d outputs, by
//   st.async into its shared memory, completing bytes on its barrier (no
//   cluster barrier at the end, no fence); each CTA waits for the cl parts
//   of its slice, merges them with weights from a fixed butterfly and
//   writes it.  CTAs with no rows send their (empty) parts all the same.
//
// rep above HEADS is split into passes of HEADS q heads, one cluster each
// (each pass reads the kv head's rows again).
//
// The partial form (decode_attention_partial_launch) is the same launch
// with the merged row written in fp32, never rounded to the input type,
// and its log-sum-exp lse = m + log l (natural log, in the units of the
// scaled scores) to one more output; a row of length 0 gives o = 0 and
// lse = -inf.  Parts of one sequence over disjoint slot ranges merge
// exactly into the whole: the caller weighs each by exp(lse - max lse).
// It is a separate instantiation: the default form's code is unchanged.

#include <cooperative_groups.h>
#include <type_traits>

#include "attn_common.cuh"
#include "hopper_mma.cuh"
#include "tma_map.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;        // CTAs per (sequence, kv head, pass)...
constexpr int REP1_CLUSTER = 4;   // ...when rep is 1 (many kv heads)
constexpr int HEADS = 8;          // q heads per pass: rows 0-7 of the mma
constexpr int SPAN_ROUND = 16;    // a CTA's span of rows: whole TMA boxes
constexpr int BOX_ROWS = 16;      // rows of a TMA box (128 bytes each)
constexpr int PS = 12;            // row stride of the p buffer, in floats
constexpr int TC_MAX = 128;       // widest head dim of the tensor-core p v
constexpr int RING_BYTES = 96 * 1024;        // rep > 1: two CTAs an SM
constexpr int REP1_RING_BYTES = 48 * 1024;   // rep 1: four CTAs an SM
constexpr int MAX_STAGES = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The head dim of the tensor-core p v, d rounded up to a multiple of 16
// (at least 64; the staged columns past d are zeros), or 0 where p v runs
// on the CUDA cores: bf16, rep > 1, d % 16 == 0 up to TC_MAX
__host__ __device__ inline int tc_dim(int D, int elt, int rep) {
  if (elt != 2 || rep == 1 || D % 16 != 0 || D > TC_MAX) return 0;
  return D <= 64 ? 64 : D;
}

// Consumer warps of a CTA, each taking its rows of every stage: 8 for the
// CUDA-core p v of grouped heads with rows up to 512 bytes (8 heads' sums a
// lane: its latency wants more warps), else 4
__host__ __device__ inline int consumers(int D, int elt, int rep) {
  return rep > 1 && !tc_dim(D, elt, rep) && D * elt <= 512 ? 8 : 4;
}

// The tile and the shared-memory layout, from d, the element size and rep
// alone (the kernel and the launcher compute the same one).
struct Layout {
  int boxc;    // columns of a 128-byte box row: 64 bf16, 32 fp32
  int ncb;     // boxes across a row: a staged row is ncb * 128 bytes
  int nc;      // 16-byte chunks of a cache row
  int cl;      // CTAs per cluster
  int cw;      // consumer warps
  int wr;      // rows of a consumer warp's block: 16 (two n8 tiles) when
               // rep > 1 and a staged row is at most 256 bytes, else 8
  int tr;      // rows of a stage: cw * wr
  int stages;  // slots of the ring
  int hm;      // q heads of the widest pass
  int phases;  // lanes that share a column chunk in p v: the row phases
  int qstride; // row stride of q in fp32 (fp32 inputs), in floats
  int slice;   // outputs per CTA slice: hm * D / cl, rounded up to 8
  // byte offsets from the 1024-aligned base: the ring at 0, [stages] slots
  // of K [ncb][tr][128 bytes] then V the same (after the last stage, the
  // consumer warps' sums [cw][hm][D + 8] fp32 over it); qf, the bf16 A
  // fragments [dq / 16][32] (or q [hm][qstride] in fp32); pb, each warp's p
  // [wr][PS] and rescale factors [8]; part, the warps' (m, l) [cw][2][8]; the
  // parts this CTA receives, one per rank: recv_ml (m, l) [cl][hm][2] and
  // recv [cl][slice] of its slice of the outputs; the full and empty
  // barriers [2][stages] and the barrier the parts arrive on
  size_t blk, slot, ring, qf, pb, part, recv_ml, recv, bars, bytes;

  __host__ __device__ Layout(int D, int elt, int rep) {
    boxc = 128 / elt;
    ncb = cdiv(D, boxc);
    nc = D * elt / 16;
    cl = rep == 1 ? REP1_CLUSTER : CLUSTER;
    wr = rep > 1 && ncb <= 2 ? 16 : 8;
    cw = consumers(D, elt, rep);
    tr = cw * wr;
    hm = imin(rep, HEADS);
    phases = nc <= 32 ? 32 / nc : 1;
    qstride = ((D / 4) | 1) * 4;
    slice = cdiv(cdiv(hm * D, cl), 8) * 8;
    blk = (size_t)tr * ncb * 128;
    slot = 2 * blk;
    const int budget = rep == 1 ? REP1_RING_BYTES : RING_BYTES;
    stages = imin(MAX_STAGES, imax(2, (int)(budget / slot)));
    ring = (size_t)stages * slot;
    const size_t sums = (size_t)cw * hm * (D + 8) * 4;
    if (ring < sums) ring = (sums + 1023) / 1024 * 1024;
    qf = ring;
    const int dq = tc_dim(D, elt, rep) ? tc_dim(D, elt, rep) : D;   // q's columns (0 past D)
    const size_t q_bytes = elt == 2 ? (size_t)cdiv(dq, 16) * 32 * 8 : (size_t)hm * qstride * 4;
    pb = qf + (q_bytes + 15) / 16 * 16;
    part = pb + (size_t)cw * (wr * PS + HEADS) * 4;
    recv_ml = part + (size_t)cw * 2 * HEADS * 4;
    recv = recv_ml + ((size_t)cl * 2 * hm * 4 + 15) / 16 * 16;
    bars = (recv + (size_t)cl * slice * 4 + 7) / 8 * 8;
    bytes = bars + (size_t)(2 * stages + 1) * 8;
    bytes = (bytes + 15) / 16 * 16 + 1024;   // 1024: room to align the base
  }
};

// the dynamic shared memory's first 1024-aligned byte: the swizzle's
// pattern follows the address bits, so every box starts 1024-aligned
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (tc::smem_u32(p) & 1023u)) & 1023u);
}

// byte offset in a stage's K or V of the 16-byte chunk cj of row r (tr rows
// a stage): box cj / 8, its row r, chunk cj % 8 swizzled by r % 8
__device__ __forceinline__ int swz(int r, int cj, int tr) {
  return (((cj >> 3) * tr + r) << 7) + (((cj & 7) ^ (r & 7)) << 4);
}

// the address in the shared memory of CTA `rank` of the cluster at p's
// offset here
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(tc::smem_u32(p)), "r"(rank));
  return r;
}

// v stored to CTA `rank`'s shared memory at dst's offset, completing as
// many bytes of the transaction count of its barrier at bar's offset
// (st.async: no fence, no cluster barrier; the receiver waits on its
// barrier)
__device__ __forceinline__ void st_async(const float* dst, int rank, float4 v, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(remote(dst, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote(bar, rank))
      : "memory");
}

__device__ __forceinline__ void st_async(const float* dst, int rank, float2 v, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      ::"r"(remote(dst, rank)), "f"(v.x), "f"(v.y), "r"(remote(bar, rank))
      : "memory");
}

// 2^x (ex2.approx: relative error below 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of a staged row, widened to fp32 (bf16 exactly)
__device__ __forceinline__ void widen(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// fp32 x, y as three bf16 pairs hi + lo + lo2, each rounded to nearest
// from what the earlier parts leave: together they hold the 24 bits of
// each value (low halves x, high halves y)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& lo,
                                       uint32_t& lo2) {
  uint32_t* parts[3] = {&hi, &lo, &lo2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
    *parts[i] = *reinterpret_cast<const uint32_t*>(&b);
    x -= __low2float(b);
    y -= __high2float(b);
  }
}

// two bf16 of q (columns c, c + 1 of row h), zero outside [hp) x [D)
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* q, int h, int c, int hp, int D) {
  if (h >= hp || c >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(q + (size_t)h * D + c);
}

// Scores of a warp's block of NT * 8 stage rows from r0 for q heads 0-7, in
// the layout of the mma accumulator: s[nt][e] = head g, row 8 nt + 2 t + e
// of the block (g = lane / 4, t = lane % 4).  bf16: NT independent mma
// chains over d, each split into even and odd steps; KD > 0 is the head dim
// rounded up to 16, known at compile time (the steps unrolled), else d is
// D at run time.  A step's columns past D are zeros in the stage and in q.
template <int NT, int KD>
__device__ __forceinline__ void scores(const __nv_bfloat16*, const unsigned char* kt, int r0,
                                       int tr, const unsigned char* qsm, int D, int hp, int lane,
                                       float (&s)[NT][2]) {
  const uint2* qf = reinterpret_cast<const uint2*>(qsm) + lane;
  const int half = (lane >> 3) & 1, r = r0 + (lane & 7);
  auto step = [&](int k, float (&c)[NT][4]) {
    const uint2 a = qf[(k / 16) * 32];
    const uint32_t af[4] = {a.x, 0u, a.y, 0u};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bf[2];
      tc::ldmatrix_x2(bf, kt + swz(r + 8 * nt, k / 8 + half, tr));
      tc::mma_bf16(c[nt], af, bf);
    }
  };
  float ca[NT][4] = {}, cb[NT][4] = {};
  if constexpr (KD > 0) {
#pragma unroll
    for (int k = 0; k < KD; k += 32) {
      step(k, ca);
      if (k + 16 < KD) step(k + 16, cb);
    }
  } else {
    int k = 0;
    for (; k + 16 < D; k += 32) {
      step(k, ca);
      step(k + 16, cb);
    }
    if (k < D) step(k, ca);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = ca[nt][0] + cb[nt][0];
    s[nt][1] = ca[nt][1] + cb[nt][1];
  }
}

// fp32: thread (g, t) dots q head g with rows 8 nt + 2 t and + 1
template <int NT, int KD>
__device__ __forceinline__ void scores(const float*, const unsigned char* kt, int r0, int tr,
                                       const unsigned char* qsm, int D, int hp, int lane,
                                       float (&s)[NT][2]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = 0.f;
  if (g >= hp) return;
  const int qstride = ((D / 4) | 1) * 4;
  const float* qr = reinterpret_cast<const float*>(qsm) + (size_t)g * qstride;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = r0 + 8 * nt + 2 * t;
    float d0 = 0.f, d1 = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qr + c);
      const float4 ka = *reinterpret_cast<const float4*>(kt + swz(r, c / 4, tr));
      const float4 kb = *reinterpret_cast<const float4*>(kt + swz(r + 1, c / 4, tr));
      d0 = fmaf(qa.x, ka.x, d0); d0 = fmaf(qa.y, ka.y, d0);
      d0 = fmaf(qa.z, ka.z, d0); d0 = fmaf(qa.w, ka.w, d0);
      d1 = fmaf(qa.x, kb.x, d1); d1 = fmaf(qa.y, kb.y, d1);
      d1 = fmaf(qa.z, kb.z, d1); d1 = fmaf(qa.w, kb.w, d1);
    }
    s[nt][0] = d0;
    s[nt][1] = d1;
  }
}

// H q heads per lane in p v on the CUDA cores (1 when rep is 1, else
// HEADS); WR rows per consumer warp block (Layout::wr); DN > 0: p v on the
// tensor cores at head dim DN (tc_dim), else on the CUDA cores; CW
// consumer warps (consumers); MINB CTAs an SM the registers must
// allow; PART: the partial form (o in fp32, and lse)
template <typename T, int H, int WR, int DN, int CW, int MINB, bool PART>
__global__ void __launch_bounds__(32 * (CW + 1), MINB)
decode_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mk16, const __grid_constant__ CUtensorMap mv16,
              const T* __restrict__ q, const int* __restrict__ lengths,
              typename std::conditional<PART, float, T>::type* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int S, int D, float scale) {
  constexpr bool TC = DN > 0;
  constexpr int THREADS = 32 * (CW + 1);
  constexpr int CH = 16 / sizeof(T);      // elements per 16-byte chunk
  constexpr int TR = CW * WR;             // rows of a stage
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rep = Hq / Hkv;
  const Layout L(D, (int)sizeof(T), rep);
  const int HM = L.hm, CL = L.cl, ST = L.stages;
  const int npass = cdiv(rep, HEADS);
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y / npass, pass = blockIdx.y % npass, b = blockIdx.z;
  const int hp = imin(HEADS, rep - pass * HEADS);   // q heads of this pass
  const int h0 = g * rep + pass * HEADS;            // its first q head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool producer = warp == CW;
  // scores in base 2: s * scale * log2(e), so that p = 2^(s2 - m2)
  const float scale2 = scale * LOG2E;

  // the slices of the hp x D outputs: CTA r of the cluster owns [r per,
  // (r + 1) per)
  const int total = hp * D;
  const int per = cdiv(cdiv(total, CL), 8) * 8;
  const int e0 = imin(total, rank * per), e1 = imin(total, e0 + per);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + ST;
  uint64_t* parts = empty + ST;           // every CTA's part of my slice is in
  const bool loader = producer && lane == 0;
  if (loader) {
    // the maps' descriptors fetched ahead of the first loads
    tc::prefetch_tensormap(&mk);
    tc::prefetch_tensormap(&mv);
    tc::prefetch_tensormap(&mk16);
    tc::prefetch_tensormap(&mv16);
    for (int s = 0; s < ST; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], CW);
    }
    tc::mbar_init(parts, 1);
    tc::mbar_init_fence();
    // from each CTA: its (m, l) per head and its sums of my slice
    tc::mbar_arrive_expect_tx(parts, (uint32_t)(CL * (8 * hp + 4 * (e1 - e0))));
  }
  // every CTA of the cluster has started before any writes to another's
  // shared memory (the matching wait comes before the first such write)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // q of this pass into the consumers' registers first, so that its loads
  // overlap the length's: bf16 A fragments [nqf / 32][32] (rows 0-7 =
  // heads, 8-15 zero), or fp32 rows [hp][D] as float4
  constexpr int CT = 32 * CW;
  constexpr int QPT = (512 + CT - 1) / CT;   // items per thread (D <= 256)
  using QItem = typename std::conditional<sizeof(T) == 2, uint2, float4>::type;
  // bf16: the A fragments of every step the scores take (DN / 16 on the
  // tensor-core path, the steps past D zero)
  const int nqf = (TC ? DN : D + 15) / 16 * 32;
  QItem qv[QPT];
  const T* qb = q + ((size_t)b * Hq + h0) * D;
  if (!producer) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * CT;
      if constexpr (sizeof(T) == 2) {
        const int kk = (i / 32) * 16, hq = (i % 32) / 4, c = kk + 2 * (i % 4);
        qv[j] = i < nqf
                    ? make_uint2(q_pair(qb, hq, c, hp, D), q_pair(qb, hq, c + 8, hp, D))
                    : make_uint2(0u, 0u);
      } else {
        qv[j] = i < hp * D / 4 ? attn::load4(qb + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // this CTA's rows [s0, s0 + cnt) of the sequence, in nst stages
  const int len = min(max(lengths[b], 0), S);
  const int span = cdiv(cdiv(len, CL), SPAN_ROUND) * SPAN_ROUND;
  const int s0 = imin(len, rank * span);
  const int cnt = imin(len, s0 + span) - s0;
  const int nst = cdiv(cnt, TR);

  // The ring's producer: stage i into slot i % ST; a box of the stage's TR
  // rows a column box (a TMA instruction costs the thread that starts it
  // about as much whatever its size), or, for a stage the length cuts, the
  // boxes of BOX_ROWS rows that hold rows below it.  Stage 0 goes before the CTA's
  // barrier, the next ST - 1 right after it, the rest once their slot's
  // last use is freed.
  auto load_stage = [&](int i) {
    const int st = i % ST, head = b * Hkv + g;
    const int rows = imin(TR, cnt - i * TR);
    const bool whole = rows == TR;
    const int nb = whole ? 1 : cdiv(rows, BOX_ROWS), box = whole ? TR : BOX_ROWS;
    tc::mbar_arrive_expect_tx(&full[st], (uint32_t)(2 * nb * box * 128 * L.ncb));
    unsigned char* kd = smem + (size_t)st * L.slot;
    for (int bx = 0; bx < nb; ++bx)
      for (int cb = 0; cb < L.ncb; ++cb) {
        const size_t off = ((size_t)cb * TR + bx * BOX_ROWS) * 128;
        const int r = s0 + i * TR + bx * BOX_ROWS;
        tc::tma_load_3d(kd + off, whole ? &mk : &mk16, cb * L.boxc, r, head, &full[st]);
        tc::tma_load_3d(kd + L.blk + off, whole ? &mv : &mv16, cb * L.boxc, r, head, &full[st]);
      }
  };
  if (loader && nst > 0) load_stage(0);
  __syncthreads();                         // the barriers are initialised

  // p v layout: lane (row phase, column chunk); NC > 32 (fp32 rows over 512
  // bytes): one row phase, chunks lane and lane + 32
  const int NC = L.nc, ncl = imin(NC, 32), phases = L.phases;
  const int cc = lane % ncl, phase = lane / ncl;
  const bool pv_lane = phase < phases;
  const bool two = NC > 32 && cc + 32 < NC;
  constexpr int E = 8;                    // sums per head per lane
  float acc[H][E];
#pragma unroll
  for (int r = 0; r < H; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  // p v on the tensor cores: ov[j] rows 0-7 (head g) take p's hi and lo2
  // parts, rows 8-15 (head g again) its lo part
  float ov[TC ? DN / 8 : 1][4] = {};
  float m_run = -INFINITY, l_run = 0.f;   // head lane / 4, this warp's rows

  if (producer) {
    if (loader)
      for (int i = 1; i < nst; ++i) {
        if (i >= ST) tc::mbar_wait(&empty[i % ST], (i / ST - 1) & 1);
        load_stage(i);
      }
    __syncwarp();
  } else {
    // -- the consumers: q to shared memory (its loads were started first)
    if constexpr (sizeof(T) == 2) {
      uint2* qf = reinterpret_cast<uint2*>(smem + L.qf);
#pragma unroll
      for (int j = 0; j < QPT; ++j)
        if (tid + j * CT < nqf) qf[tid + j * CT] = qv[j];
    } else {
      float* qs = reinterpret_cast<float*>(smem + L.qf);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int i = tid + j * CT;
        if (i < hp * D / 4)
          *reinterpret_cast<float4*>(qs + (i / (D / 4)) * L.qstride + 4 * (i % (D / 4))) = qv[j];
      }
    }
    tc::named_bar_sync(1, CT);             // q is in shared memory

    float* pb = reinterpret_cast<float*>(smem + L.pb) + warp * (WR * PS + HEADS);
    float* pcorr = pb + WR * PS;
    const int r0 = warp * WR;              // this warp's rows of a stage
    for (int i = 0; i < nst; ++i) {
      const int st = i % ST;
      tc::mbar_wait(&full[st], (i / ST) & 1);
      const int nv = imin(WR, cnt - i * TR - r0);   // rows of this block
      if (nv > 0) {
        const unsigned char* kt = smem + (size_t)st * L.slot;
        const unsigned char* vt = kt + L.blk;
        // -- scores (base 2) and the online softmax of head lane / 4 -------
        constexpr int NT = WR / 8;
        float x[NT][2];
        scores<NT, DN>(static_cast<const T*>(nullptr), kt, r0, TR, smem + L.qf, D, hp, lane, x);
        const int tg = lane % 4, hg = lane / 4;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // rows past the length (anything, NaN included) get -inf: p = 0
            x[nt][e] = 8 * nt + 2 * tg + e < nv ? x[nt][e] * scale2 : -INFINITY;
            mx = fmaxf(mx, x[nt][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run, mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // heads past hp (zero rows of q) get p = 0 and no rescaling, so
            // p v runs over all heads without a branch
            x[nt][e] = hg < hp ? ex2(x[nt][e] - m_new) : 0.f;   // now p
            sum += x[nt][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float corr = hg < hp ? ex2(m_run - m_new) : 1.f;   // 0 at first
        l_run = l_run * corr + sum;
        m_run = m_new;

        if constexpr (TC) {
          // -- p v on the tensor cores: p (the scores' accumulator layout is
          // the A fragment of the product: head g, rows 2t, 2t + 1, 8 + 2t,
          // 9 + 2t) as the exact sum of three bf16 parts, V through
          // ldmatrix.trans, its rows past the length zeroed in the fragment
          // (0 * NaN would be NaN); each product exact, sums in fp32.  Rows
          // 0-7 of the first product's A are hi and rows 8-15 lo, the second
          // product's rows 0-7 lo2: two products a tile, every row used.
          // ov[j] holds head g, columns 8 j + 2t, 8 j + 2t + 1 in [0, 1]
          // (hi, lo2) and [2, 3] (lo)
          uint32_t hi[2], lo[2], lo2[2];
          split3(x[0][0], x[0][1], hi[0], lo[0], lo2[0]);
          split3(x[1][0], x[1][1], hi[1], lo[1], lo2[1]);
          const uint32_t a1[4] = {hi[0], lo[0], hi[1], lo[1]};
          const uint32_t a2[4] = {lo2[0], 0u, lo2[1], 0u};
          if (corr != 1.f)
#pragma unroll
            for (int j = 0; j < DN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) ov[j][e] *= corr;
          const uint32_t m0 = (2 * tg < nv ? 0xffffu : 0u) | (2 * tg + 1 < nv ? 0xffff0000u : 0u);
          const uint32_t m1 =
              (2 * tg + 8 < nv ? 0xffffu : 0u) | (2 * tg + 9 < nv ? 0xffff0000u : 0u);
          const int vr = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int j = 0; j < DN / 8; j += 2) {
            uint32_t bv[4];
            tc::ldmatrix_x4_trans(bv, vt + swz(vr, j + (lane >> 4), TR));
            bv[0] &= m0;
            bv[1] &= m1;
            bv[2] &= m0;
            bv[3] &= m1;
            tc::mma_bf16(ov[j], a2, bv);
            tc::mma_bf16(ov[j + 1], a2, bv + 2);
            tc::mma_bf16(ov[j], a1, bv);
            tc::mma_bf16(ov[j + 1], a1, bv + 2);
          }
        } else {
          // -- p v on the CUDA cores: my column chunk(s), my heads, my rows
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) pb[(8 * nt + 2 * tg + e) * PS + hg] = x[nt][e];
          if (tg == 0) pcorr[hg] = corr;
          __syncwarp();
          if (pv_lane) {
            float f[H];
            bool rescale = false;
#pragma unroll
            for (int r = 0; r < H; ++r) {
              f[r] = pcorr[r];
              rescale |= f[r] != 1.f;
            }
            if (rescale)                   // a new running max for a head
#pragma unroll
              for (int r = 0; r < H; ++r)
#pragma unroll
                for (int e = 0; e < E; ++e) acc[r][e] *= f[r];
#pragma unroll 4
            for (int j = phase; j < nv; j += phases) {
              float vf[E];
              widen(reinterpret_cast<const T*>(vt + swz(r0 + j, cc, TR)), vf);
              if constexpr (CH == 4) {
                if (two) widen(reinterpret_cast<const T*>(vt + swz(r0 + j, cc + 32, TR)), vf + 4);
              }
              float p[H];
              if constexpr (H == HEADS) {
                const float4 pa = *reinterpret_cast<const float4*>(pb + j * PS);
                const float4 pc = *reinterpret_cast<const float4*>(pb + j * PS + 4);
                p[0] = pa.x; p[1] = pa.y; p[2] = pa.z; p[3] = pa.w;
                p[4] = pc.x; p[5] = pc.y; p[6] = pc.z; p[7] = pc.w;
              } else {
#pragma unroll
                for (int r = 0; r < H; ++r) p[r] = pb[j * PS + r];
              }
#pragma unroll
              for (int r = 0; r < H; ++r)
#pragma unroll
                for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p[r], vf[e], acc[r][e]);
            }
          }
        }
      }
      __syncwarp();                        // the warp is done with slot st
      if (lane == 0) tc::mbar_arrive(&empty[st]);
    }
    // the row phases' sums, in phase order, into the phase-0 lanes
    if constexpr (!TC)
      for (int ph = 1; ph < phases; ++ph)
#pragma unroll
        for (int r = 0; r < H; ++r)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float t = __shfl_down_sync(0xffffffffu, acc[r][e], ph * ncl);
            if (phase == 0) acc[r][e] += t;
          }
  }

  // -- merge the warps inside the CTA, then the CTA's part across the
  // cluster.  The ring is drained: every stage loaded was waited for.
  __syncthreads();
  const int WS = D + 8;                   // a head's stride in wsum: float2 stores
                                          // of the 8 heads fall in distinct banks
  float* wsum = reinterpret_cast<float*>(smem);             // [CW][HM][WS]
  float* wml = reinterpret_cast<float*>(smem + L.part);     // [CW][2][HEADS]
  float* recv_ml = reinterpret_cast<float*>(smem + L.recv_ml);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  if (!producer) {
    float* ws = wsum + (size_t)warp * HM * WS;
    if (lane % 4 == 0 && lane / 4 < hp) {
      wml[warp * 2 * HEADS + lane / 4] = m_run;
      wml[(warp * 2 + 1) * HEADS + lane / 4] = l_run;
    }
    if constexpr (TC) {
      if (lane / 4 < hp)
#pragma unroll
        for (int j = 0; j < DN / 8; ++j)
          if (8 * j < D)
            *reinterpret_cast<float2*>(ws + (lane / 4) * WS + 8 * j + 2 * (lane % 4)) =
                make_float2(ov[j][0] + ov[j][2], ov[j][1] + ov[j][3]);
    } else if (phase == 0) {
#pragma unroll
      for (int r = 0; r < H; ++r) {
        if (r < hp) {
#pragma unroll
          for (int e = 0; e < CH; e += 4)
            *reinterpret_cast<float4*>(ws + r * WS + cc * CH + e) =
                make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
          if (CH == 4 && two)
            *reinterpret_cast<float4*>(ws + r * WS + (cc + 32) * 4) =
                make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
        }
      }
    }
  }
  __syncthreads();
  // The CTA's part, 4 outputs a thread: per head the CTA's max m, each
  // warp's weight 2^(m_w - m), the CTA's l and sums, in warp order; as
  // they are, to the CTA of the cluster that owns that slice of the
  // outputs, part `rank` of its receive buffers (m and l, from the thread
  // of the head's first 4 outputs, to every CTA)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  for (int e = 4 * tid; e < total; e += 4 * THREADS) {
    const int h = e / D, c = e - h * D;   // D % 4 == 0: 4 outputs, one head
    float mx = -INFINITY;
    for (int w = 0; w < CW; ++w) mx = fmaxf(mx, wml[w * 2 * HEADS + h]);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int w = 0; w < CW; ++w) {
      const float m = wml[w * 2 * HEADS + h];
      const float f = m == -INFINITY ? 0.f : ex2(m - mx);
      l += wml[(w * 2 + 1) * HEADS + h] * f;
      const float4 a = *reinterpret_cast<const float4*>(wsum + ((size_t)w * HM + h) * WS + c);
      s.x = fmaf(a.x, f, s.x);
      s.y = fmaf(a.y, f, s.y);
      s.z = fmaf(a.z, f, s.z);
      s.w = fmaf(a.w, f, s.w);
    }
    const int owner = e / per;             // a chunk of 4 never straddles owners
    st_async(recv + (size_t)rank * L.slice + e - owner * per, owner, s, parts);
    if (c == 0)
      for (int r = 0; r < CL; ++r)
        st_async(recv_ml + (rank * HM + h) * 2, r, make_float2(mx, l), parts);
  }
  tc::mbar_wait_cluster(parts, 0);         // every part has arrived

  // -- the outputs this CTA owns: the parts merged in rank order, each
  // weighed by 2^(m_p - m), their l summed pairwise (the same tree on
  // every call); each thread takes its heads' weights itself
  for (int e = e0 + tid; e < e1; e += THREADS) {
    const int h = e / D;
    float mx = -INFINITY;
    for (int p = 0; p < CL; ++p) mx = fmaxf(mx, recv_ml[(p * HM + h) * 2]);
    float f[CLUSTER], lp[CLUSTER];
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p) {
      const float m = p < CL ? recv_ml[(p * HM + h) * 2] : -INFINITY;
      f[p] = m == -INFINITY ? 0.f : ex2(m - mx);
      lp[p] = p < CL ? recv_ml[(p * HM + h) * 2 + 1] * f[p] : 0.f;
    }
#pragma unroll
    for (int w = 1; w < CLUSTER; w <<= 1)
#pragma unroll
      for (int p = 0; p < CLUSTER; p += 2 * w) lp[p] += lp[p + w];
    const float l = lp[0];
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p)
      if (p < CL) s = fmaf(recv[(size_t)p * L.slice + e - e0], f[p], s);
    attn::store1(o + ((size_t)b * Hq + h0) * D + e, s * (l > 0.f ? 1.f / l : 0.f));
    if constexpr (PART)
      if (e == h * D)                      // natural log: m is in base 2
        lse[(size_t)b * Hq + h0 + h] = l > 0.f ? mx * LN2 + logf(l) : -INFINITY;
  }
}

// The launch configuration a call gets: info [grid x, y, z, cluster,
// threads, shared bytes, CTAs an SM can hold, clusters the card can hold at
// once, tensor-core p v (0/1), ring stages, rows a stage]
template <typename T, bool PART, int H, int WR, int DN, int CW, int MINB>
int launch_with(const void* q, const void* k, const void* v, const int* lengths, void* o,
                float* lse, int N, int Hq, int Hkv, int S, int D, float scale, const Layout& L,
                cudaStream_t stream, int* info) {
  using O = typename std::conditional<PART, float, T>::type;
  constexpr int THREADS = 32 * (CW + 1);
  const int smem = (int)L.bytes;
  auto kernel = decode_kernel<T, H, WR, DN, CW, MINB, PART>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.cl, Hkv * cdiv(Hq / Hkv, HEADS), N);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (info != nullptr) {
    int per_sm = 0, clusters = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    const int vals[11] = {(int)cfg.gridDim.x, (int)cfg.gridDim.y, (int)cfg.gridDim.z, L.cl,
                          THREADS, smem, per_sm, clusters, DN > 0 ? 1 : 0, L.stages, L.tr};
    for (int i = 0; i < 11; ++i) info[i] = vals[i];
    return 0;
  }
  // maps with boxes of a whole stage's rows and of BOX_ROWS rows
  CUtensorMap mk, mv, mk16, mv16;
  const int elt = (int)sizeof(T), heads = N * Hkv;
  int e = tma_map::make_3d(&mk, k, elt, D, S, heads, L.boxc, L.tr);
  if (e == 0) e = tma_map::make_3d(&mv, v, elt, D, S, heads, L.boxc, L.tr);
  if (e == 0) e = tma_map::make_3d(&mk16, k, elt, D, S, heads, L.boxc, BOX_ROWS);
  if (e == 0) e = tma_map::make_3d(&mv16, v, elt, D, S, heads, L.boxc, BOX_ROWS);
  if (e != 0) return e;
  err = cudaLaunchKernelEx(&cfg, kernel, mk, mv, mk16, mv16, static_cast<const T*>(q), lengths,
                           static_cast<O*>(o), lse, Hq, Hkv, S, D, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool PART, int DN>
int launch_tc(const void* q, const void* k, const void* v, const int* lengths, void* o,
              float* lse, int N, int Hq, int Hkv, int S, int D, float scale, const Layout& L,
              cudaStream_t stream, int* info) {
  return launch_with<T, PART, HEADS, 16, DN, 4, 2>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D,
                                                   scale, L, stream, info);
}

template <typename T, bool PART>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, float* lse,
           int N, int Hq, int Hkv, int S, int D, float scale, cudaStream_t stream, int* info) {
  const int rep = Hq / Hkv, elt = (int)sizeof(T);
  if ((long long)Hkv * cdiv(rep, HEADS) > 65535) return (int)cudaErrorInvalidValue;
  const Layout L(D, elt, rep);
  if (L.bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (rep == 1)
    return launch_with<T, PART, 1, 8, 0, 4, 4>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale,
                                                L, stream, info);
  if constexpr (sizeof(T) == 2) {          // p v on the tensor cores
    switch (tc_dim(D, elt, rep)) {
#define DECODE_TC(DN)                                                                          \
  case DN:                                                                                     \
    return launch_tc<T, PART, DN>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, L, stream, \
                                  info);
      DECODE_TC(64)
      DECODE_TC(80)
      DECODE_TC(96)
      DECODE_TC(112)
      DECODE_TC(128)
#undef DECODE_TC
      default: break;
    }
  }
  if (L.cw == 4)                           // rows over 512 bytes
    return launch_with<T, PART, HEADS, 8, 0, 4, 2>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D,
                                                   scale, L, stream, info);
  if (L.wr == 8)
    return launch_with<T, PART, HEADS, 8, 0, 8, 1>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D,
                                                   scale, L, stream, info);
  return launch_with<T, PART, HEADS, 16, 0, 8, 1>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D,
                                                  scale, L, stream, info);
}

template <bool PART>
int launch_dtype(const void* q, const void* k, const void* v, const int* lengths, void* o,
                 float* lse, int N, int Hq, int Hkv, int S, int D, float scale, int dtype,
                 cudaStream_t stream, int* info = nullptr) {
  const int elt = dtype == 0 ? 4 : 2;
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D * elt % 16 != 0 || D > 256 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, PART>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, stream, info);
  if (dtype == 1)
    return launch<__nv_bfloat16, PART>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, stream,
                                       info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [N, Hq, D], k/v caches [N, Hkv, S, D], lengths [N] int32, o [N, Hq, D],
// contiguous and 16-byte aligned, q/k/v/o of one type: dtype 0 = fp32,
// 1 = bf16.  D * element size a multiple of 16, D <= 256, Hq % Hkv == 0.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* lengths, void* o, int N, int Hq, int Hkv,
                                       int S, int D, float scale, int dtype,
                                       cudaStream_t stream) {
  return launch_dtype<false>(q, k, v, lengths, o, nullptr, N, Hq, Hkv, S, D, scale, dtype,
                             stream);
}

// The partial form: as above, but o [N, Hq, D] is fp32 whatever the inputs'
// type, and lse [N, Hq] fp32 gets each row's log-sum-exp (-inf at length 0).
extern "C" int decode_attention_partial_launch(const void* q, const void* k, const void* v,
                                               const int* lengths, float* o, float* lse, int N,
                                               int Hq, int Hkv, int S, int D, float scale,
                                               int dtype, cudaStream_t stream) {
  return launch_dtype<true>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, dtype, stream);
}

// The default form's launch configuration at these sizes, launching
// nothing: info [11] as launch_with writes it.
extern "C" int decode_attention_config(int N, int Hq, int Hkv, int S, int D, int dtype,
                                       int* info) {
  return launch_dtype<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, N, Hq, Hkv, S,
                             D, 1.f, dtype, nullptr, info);
}
