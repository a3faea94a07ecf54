// Single-token decode attention against a KV cache, grouped-query heads:
// out[b, h] = softmax(q[b, h] . k[b, g, :len] * scale) v[b, g, :len] with
// g = h / rep, rep = Hq / Hkv.  fp32 or bf16 inputs, fp32 softmax and
// accumulation, output in the input type.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention
// (_dec_kernel), the LM serving step's attention.  A sequence of length 0
// gives 0.
//
// Bound on the H100: bytes.  Each valid cache row is read once for all rep
// q heads of its kv head; 4 * rep * d FLOPs per row of 2 * d elements.  The
// (sequence, kv head) pairs are few (16 for Qwen2-7B at batch 4 against 132
// SMs), so each pair's rows are split over a thread block cluster, and one
// launch does the whole call, with no partials in global memory and no
// atomics:
//
// - Partition.  CTA r of a cluster of cl CTAs (8; 4 when rep is 1, whose
//   many kv heads fill the card) takes rows [r * span, (r + 1) * span) below
//   the length, span = ceil(len / cl) rounded up to SPAN_ROUND; rows at or
//   past lengths[b] are never read.  Inside the CTA, warp w takes blocks
//   of wrows rows, [i * wrows * warps + w * wrows, + wrows).  All of this
//   depends on the length, d, rep and the dtype alone, so a sequence's bits
//   do not depend on the batch, on S or on the other sequences' lengths.
// - Staged rows.  Each warp streams its own blocks through its own ring of
//   two slots in shared memory by cp.async, 16 bytes a lane with
//   neighbouring lanes on neighbouring bytes; the next block is in flight
//   while one is computed, and no barrier joins the warps inside the loop.
//   Rows sit at an odd number of 16-byte units, so the eight rows of an
//   ldmatrix or of a quarter-warp's loads fall in distinct banks.
// - Each warp keeps its own online softmax (m, l) per head and its sums, in
//   fp32.  Scores: bf16 q k^T on mma.sync m16n8k16 (up to 8 q heads in rows
//   0-7 of A, the block's rows as B through ldmatrix; exact products, fp32
//   sums), fp32 on the CUDA cores in the mma's accumulator layout.  p v:
//   for bf16 with rep > 1 and d 128 (the GQA models' head dim) on
//   mma.sync too, p (fp32, the scores' accumulator reused as the A
//   fragment) split exactly into three bf16 parts, V through
//   ldmatrix.trans; otherwise on the CUDA cores
//   in fp32, each lane holding up to 8 heads' sums of a 16-byte column
//   chunk, p from the warp's buffer in shared memory.  p is never rounded
//   to bf16; bf16 inputs widen exactly.
// - Merge.  Every warp's (m, l, sums) goes, as it is, into the shared
//   memory of the CTA of the cluster that owns that slice of the heads x d
//   outputs (distributed shared memory); after one cluster barrier each
//   CTA merges its slice over the parts in (rank, warp) order and writes
//   it.  CTAs with no rows take part in every cluster barrier.
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

namespace {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;        // CTAs per (sequence, kv head, pass)...
constexpr int REP1_CLUSTER = 4;   // ...when rep is 1 (many kv heads)
constexpr int HEADS = 8;          // q heads per pass: rows 0-7 of the mma
constexpr int SPAN_ROUND = 16;    // a CTA's span of rows: a multiple
constexpr int PS = 12;            // row stride of the p buffer, in floats
constexpr int STAGES = 2;         // slots of each warp's ring

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The head dim of the tensor-core p v path (bf16, rep > 1 and d 128, the
// bf16 grouped-query models' head dim and the one it is compiled for),
// else 0
__host__ __device__ inline int tc_dim(int D, int elt, int rep) {
  return elt == 2 && rep > 1 && D == 128 ? D : 0;
}

// The tile and the shared-memory layout, from d, the element size and rep
// alone (the kernel and the launcher compute the same one).
struct Layout {
  int nc;      // 16-byte chunks of a cache row
  int units;   // row stride of staged K, in 16-byte units (odd)
  int vunits;  // that of V: odd for ldmatrix on the tensor-core path, else nc
  int cl;      // CTAs per cluster
  int warps;   // warps per CTA: 8; 4 for rep 1 or rows over 512 bytes
  int wrows;   // rows of a warp's block: 16 (two n8 tiles); 8 when rep is
               // 1 or rows are over 256 bytes
  int rows;    // CTA rows per round: each warp takes wrows of them
  int hm;      // q heads of the widest pass
  int phases;  // lanes that share a column chunk in p v: the row phases
  int qstride; // row stride of q in fp32 (fp32 inputs), in floats
  // byte offsets: the warps' rings at 0, [warps][STAGES] slots of K
  // [wrows][units * 16] then V [wrows][vunits * 16].  Then qf, the bf16 A
  // fragments [D / 16][32] (or q [hm][qstride] in fp32); pb, each warp's p
  // [wrows][PS] and rescale factors [8]; the parts this CTA receives, one
  // per (rank, warp) of the cluster: recv_ml (m, l) [cl * warps][2][hm]
  // and recv [cl * warps][slice] of its slice of the outputs; wts, their
  // merge weights [hm][cl * warps] and 1 / l [hm].
  size_t k_blk, slot, qf, pb, recv_ml, recv, wts, bytes;
  int slice;   // outputs per CTA slice: hm * D / cl, rounded up to 8

  __host__ __device__ Layout(int D, int elt, int rep) {
    const int row_bytes = D * elt;
    nc = row_bytes / 16;
    units = nc | 1;
    vunits = tc_dim(D, elt, rep) ? units : nc;
    cl = rep == 1 ? REP1_CLUSTER : CLUSTER;
    warps = rep > 1 && row_bytes <= 512 ? 8 : 4;
    wrows = rep == 1 || row_bytes > 256 ? 8 : 16;
    rows = wrows * warps;
    hm = imin(rep, HEADS);
    phases = nc <= 32 ? 32 / nc : 1;
    qstride = ((D / 4) | 1) * 4;
    slice = cdiv(cdiv(hm * D, cl), 8) * 8;
    k_blk = (size_t)wrows * units * 16;
    slot = k_blk + (size_t)wrows * vunits * 16;
    qf = (size_t)warps * STAGES * slot;
    const size_t q_bytes = elt == 2 ? (size_t)cdiv(D, 16) * 32 * 8
                                    : (size_t)hm * qstride * 4;
    pb = qf + q_bytes;
    const int parts = cl * warps;
    recv_ml = pb + (size_t)warps * (wrows * PS + HEADS) * 4;
    recv = recv_ml + (size_t)parts * 2 * hm * 4;
    wts = recv + (size_t)parts * slice * 4;
    bytes = wts + (size_t)hm * (parts + 1) * 4;
    bytes = (bytes + 15) / 16 * 16;
  }
};

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

// Scores of this warp's block of NT * 8 rows for q heads 0-7, in the
// layout of the mma accumulator: s[nt][e] = head g, row 8 nt + 2 t + e of
// the block (g = lane / 4, t = lane % 4).  bf16: NT independent mma chains
// over d, each split into even and odd steps; KD > 0 is d known at compile
// time (a multiple of 16), which unrolls the steps.
template <int NT, int KD>
__device__ __forceinline__ void scores(const __nv_bfloat16* kt, const unsigned char* qsm, int U,
                                       int D, int hp, int lane, float (&s)[NT][2]) {
  if constexpr (KD > 0) D = KD;
  const uint2* qf = reinterpret_cast<const uint2*>(qsm) + lane;
  const int half = (lane >> 3) & 1;
  const __nv_bfloat16* kr = kt + ((size_t)(lane & 7) * U + half) * 8;
  // one step: columns k..k + 15 (the upper 8 zero past D, a ragged last step)
  auto step = [&](int k, float (&c)[NT][4]) {
    const uint2 a = qf[(k / 16) * 32];
    const uint32_t af[4] = {a.x, 0u, a.y, 0u};
    const bool ragged = k + 8 >= D;
    const int off = ragged ? k - 8 * half : k;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bf[2];
      tc::ldmatrix_x2(bf, kr + (size_t)nt * 8 * U * 8 + off);
      if (ragged) bf[1] = 0u;
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
__device__ __forceinline__ void scores(const float* kt, const unsigned char* qsm, int U, int D,
                                       int hp, int lane, float (&s)[NT][2]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = 0.f;
  if (g >= hp) return;
  const int qstride = ((D / 4) | 1) * 4;
  const float* qr = reinterpret_cast<const float*>(qsm) + (size_t)g * qstride;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* k0 = kt + (size_t)(8 * nt + 2 * t) * U * 4;
    const float* k1 = k0 + (size_t)U * 4;
    float d0 = 0.f, d1 = 0.f;
    for (int c = 0; c < D; c += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(qr + c);
      const float4 ka = *reinterpret_cast<const float4*>(k0 + c);
      const float4 kb = *reinterpret_cast<const float4*>(k1 + c);
      d0 = fmaf(qa.x, ka.x, d0); d0 = fmaf(qa.y, ka.y, d0);
      d0 = fmaf(qa.z, ka.z, d0); d0 = fmaf(qa.w, ka.w, d0);
      d1 = fmaf(qa.x, kb.x, d1); d1 = fmaf(qa.y, kb.y, d1);
      d1 = fmaf(qa.z, kb.z, d1); d1 = fmaf(qa.w, kb.w, d1);
    }
    s[nt][0] = d0;
    s[nt][1] = d1;
  }
}

// W warps; H q heads per lane in p v on the CUDA cores (1 when rep is 1,
// else HEADS); WR rows per warp block (L.wrows); TC > 0: p v on the tensor
// cores for bf16, rep > 1, 16-row blocks and head dim TC (128, known at
// compile time), else 0; PART: the partial form (o in fp32, and lse)
template <typename T, int W, int H, int WR, int TC, bool PART>
__global__ void __launch_bounds__(32 * W, (H == 1 ? 24 : 8) / W)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              typename std::conditional<PART, float, T>::type* __restrict__ o,
              float* __restrict__ lse, int Hq, int Hkv, int S, int D, float scale) {
  constexpr int THREADS = 32 * W;
  constexpr int CH = 16 / sizeof(T);      // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rep = Hq / Hkv;
  const Layout L(D, (int)sizeof(T), rep);
  const int R = L.rows, U = L.units, NC = L.nc, HM = L.hm;
  const int npass = cdiv(rep, HEADS);
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.y / npass, pass = blockIdx.y % npass, b = blockIdx.z;
  const int hp = imin(HEADS, rep - pass * HEADS);   // q heads of this pass
  const int h0 = g * rep + pass * HEADS;            // its first q head
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float* pb = reinterpret_cast<float*>(smem + L.pb) + warp * (WR * PS + HEADS);
  float* pcorr = pb + WR * PS;
  float* recv_ml = reinterpret_cast<float*>(smem + L.recv_ml);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  float* wts = reinterpret_cast<float*>(smem + L.wts);

  // every CTA of the cluster has started before any writes to another's
  // shared memory (the matching wait comes before the first such write)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // q of this pass into registers first, so that its loads overlap the
  // length's and the first blocks': bf16 A fragments [D / 16][32] (rows
  // 0-7 = heads, 8-15 zero), or fp32 rows [hp][D] as float4
  constexpr int QPT = 512 / THREADS;      // items per thread (D <= 256)
  using QItem = typename std::conditional<sizeof(T) == 2, uint2, float4>::type;
  QItem qv[QPT];
  const T* qb = q + ((size_t)b * Hq + h0) * D;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int i = tid + j * THREADS;
    if constexpr (sizeof(T) == 2) {
      const int kk = (i / 32) * 16, hq = (i % 32) / 4, c = kk + 2 * (i % 4);
      qv[j] = i < cdiv(D, 16) * 32
                  ? make_uint2(q_pair(qb, hq, c, hp, D), q_pair(qb, hq, c + 8, hp, D))
                  : make_uint2(0u, 0u);
    } else {
      qv[j] = i < hp * D / 4 ? attn::load4(qb + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // this CTA's rows [s0, s0 + cnt) of the sequence
  const int len = min(max(lengths[b], 0), S);
  const int CL = L.cl;
  const int span = cdiv(cdiv(len, CL), SPAN_ROUND) * SPAN_ROUND;
  const int s0 = imin(len, rank * span);
  const int cnt = imin(len, s0 + span) - s0;
  const size_t row0 = ((size_t)b * Hkv + g) * S + s0;
  const unsigned char* Kb = reinterpret_cast<const unsigned char*>(k + row0 * D);
  const unsigned char* Vb = reinterpret_cast<const unsigned char*>(v + row0 * D);

  // Each warp streams its own rows through its own ring: block i of warp
  // w is CTA rows [i * R + WR w, + WR), copied by cp.async into slot
  // i % STAGES, lane l the 16-byte chunks l, l + 32, ... of the block; rows
  // past the length are zero-filled, not read (the p v product on the
  // tensor cores multiplies them by p = 0).
  const int jw = warp * WR;
  const int nblk = cnt > jw ? cdiv(cnt - jw, R) : 0;
  unsigned char* ring = smem + (size_t)warp * STAGES * L.slot;
  const int lr0 = lane / NC, lc0 = lane % NC, rstep = 32 / NC, cstep = 32 % NC;
  auto load_blk = [&](int i) {
    unsigned char* kd = ring + (size_t)(i % STAGES) * L.slot;
    unsigned char* vd = kd + L.k_blk;
    const int r0 = i * R + jw, n = imin(WR, cnt - r0);
    const unsigned char* ks = Kb + (size_t)r0 * NC * 16;
    const unsigned char* vs = Vb + (size_t)r0 * NC * 16;
    for (int r = lr0, c = lc0; r < WR;) {
      const size_t src = r < n ? ((size_t)r * NC + c) * 16 : 0;
      tc::cp_async16(kd + ((size_t)r * U + c) * 16, ks + src, r < n);
      tc::cp_async16(vd + ((size_t)r * L.vunits + c) * 16, vs + src, r < n);
      r += rstep;
      c += cstep;
      if (c >= NC) { c -= NC; ++r; }
    }
  };
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nblk) load_blk(i);
    tc::cp_async_commit();
  }

  // q to shared memory (its loads were issued first)
  if constexpr (sizeof(T) == 2) {
    uint2* qf = reinterpret_cast<uint2*>(smem + L.qf);
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      if (tid + j * THREADS < cdiv(D, 16) * 32) qf[tid + j * THREADS] = qv[j];
  } else {
    float* qs = reinterpret_cast<float*>(smem + L.qf);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * THREADS;
      if (i < hp * D / 4)
        *reinterpret_cast<float4*>(qs + (i / (D / 4)) * L.qstride + 4 * (i % (D / 4))) = qv[j];
    }
  }

  // p v layout: lane (row phase, column chunk); NC > 32 (fp32 rows over 512
  // bytes): one row phase, chunks lane and lane + 32
  const int ncl = imin(NC, 32), phases = L.phases;
  const int cc = lane % ncl, phase = lane / ncl;
  const bool pv_lane = phase < phases;
  const bool two = NC > 32 && cc + 32 < NC;
  constexpr int E = 8;                    // sums per head per lane
  float acc[H][E];
#pragma unroll
  for (int r = 0; r < H; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  float ov[TC ? TC / 8 : 1][4] = {};      // p v on the tensor cores
  float m_run = -INFINITY, l_run = 0.f;   // head lane / 4, this warp's rows
  __syncthreads();                         // q is in shared memory

  for (int i = 0; i < nblk; ++i) {
    __syncwarp();                          // block i - 1 is done: its slot is free
    if (i + STAGES - 1 < nblk) load_blk(i + STAGES - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();       // block i is in (the newer may not be)
    __syncwarp();
    const int nv = imin(WR, cnt - (i * R + jw));   // rows of block i
    const unsigned char* sl = ring + (size_t)(i % STAGES) * L.slot;
    const T* kt = reinterpret_cast<const T*>(sl);
    const T* vt = reinterpret_cast<const T*>(sl + L.k_blk);
    // -- scores and the online softmax of head lane / 4 ---------------------
    constexpr int NT = WR / 8;
    float x[NT][2];
    scores<NT, TC>(kt, smem + L.qf, U, D, hp, lane, x);
    const int tg = lane % 4, hg = lane / 4;
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[nt][e] = 8 * nt + 2 * tg + e < nv ? x[nt][e] * scale : -INFINITY;
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
        x[nt][e] = hg < hp ? expf(x[nt][e] - m_new) : 0.f;   // now p
        sum += x[nt][e];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = hg < hp ? expf(m_run - m_new) : 1.f;   // 0 at first
    l_run = l_run * corr + sum;
    m_run = m_new;

    if constexpr (TC) {
      // -- p v on the tensor cores: p (the scores' accumulator layout is the
      // A fragment of the product: head g, rows 2t, 2t + 1, 8 + 2t, 9 + 2t)
      // as the exact sum of three bf16 parts, V through ldmatrix.trans;
      // each product exact, sums in fp32.  ov[j] holds head g, columns
      // 8 j + 2t, 8 j + 2t + 1 (rows 8-15 of the mma are unused)
      uint32_t ap[3][4];
      split3(x[0][0], x[0][1], ap[0][0], ap[1][0], ap[2][0]);
      split3(x[1][0], x[1][1], ap[0][2], ap[1][2], ap[2][2]);
#pragma unroll
      for (int t3 = 0; t3 < 3; ++t3) ap[t3][1] = ap[t3][3] = 0u;
      if (corr != 1.f)
#pragma unroll
        for (int j = 0; j < TC / 8; ++j) {
          ov[j][0] *= corr;
          ov[j][1] *= corr;
        }
      const __nv_bfloat16* vr = reinterpret_cast<const __nv_bfloat16*>(vt) +
                                ((size_t)((lane & 7) + 8 * ((lane >> 3) & 1)) * U +
                                 (lane >> 4)) * 8;
#pragma unroll
      for (int j = 0; j < TC / 8; j += 2) {
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, vr + 8 * j);
#pragma unroll
        for (int t3 = 2; t3 >= 0; --t3) {
          tc::mma_bf16(ov[j], ap[t3], bv);
          tc::mma_bf16(ov[j + 1], ap[t3], bv + 2);
        }
      }
    } else {
      // -- p v on the CUDA cores: my column chunk(s), my heads, my rows ----
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
        if (rescale)                       // a new running max for a head
#pragma unroll
          for (int r = 0; r < H; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] *= f[r];
#pragma unroll 4
        for (int j = phase; j < nv; j += phases) {
          float vf[E];
          const T* vr = vt + (size_t)j * L.vunits * CH;
          widen(vr + cc * CH, vf);
          if constexpr (CH == 4) {
            if (two) widen(vr + (cc + 32) * CH, vf + 4);
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
      __syncwarp();
    }
  }
  tc::cp_async_wait<0>();

  // -- merge the warps, then the cluster --------------------------------------
  // (runs once per CTA, from a cold instruction cache: few, short steps)
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
  // each warp's (m, l) and sums, as they are, to the CTA of the cluster
  // that owns the outputs: part (rank, warp) of its receive buffers
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all started
  const int part = rank * W + warp, total = hp * D;
  const int per = cdiv(cdiv(total, CL), 8) * 8;   // outputs per owner
  if (lane % 4 == 0 && lane / 4 < hp)
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      float* dst = cluster.map_shared_rank(recv_ml, r) + part * 2 * HM + lane / 4;
      dst[0] = m_run;
      dst[HM] = l_run;
    }
  // the remote address of output e (a chunk of 8 never straddles owners)
  auto remote = [&](int e) {
    const int owner = e / per;
    return cluster.map_shared_rank(recv, owner) + (size_t)part * L.slice + e - owner * per;
  };
  if constexpr (TC) {
    if (lane / 4 < hp)
#pragma unroll
      for (int j = 0; j < TC / 8; ++j)
        *reinterpret_cast<float2*>(remote((lane / 4) * D + 8 * j + 2 * (lane % 4))) =
            make_float2(ov[j][0], ov[j][1]);
  } else if (phase == 0) {
#pragma unroll
    for (int r = 0; r < H; ++r) {
      if (r < hp) {
#pragma unroll
        for (int e = 0; e < CH; e += 4)
          *reinterpret_cast<float4*>(remote(r * D + cc * CH + e)) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
        if (CH == 4 && two)
          *reinterpret_cast<float4*>(remote(r * D + (cc + 32) * 4)) =
              make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
  cluster.sync();                          // every part has arrived

  // -- the outputs this CTA owns: the parts merged in (rank, warp) order ----
  // per head, a warp at a time: the parts' max, weights exp(m_p - m) and l
  const int PARTS = CL * W;                // lane l: parts l and l + 32
  for (int h = warp; h < hp; h += W) {
    float m[2], mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      m[i] = p < PARTS ? recv_ml[p * 2 * HM + h] : -INFINITY;
      mx = fmaxf(mx, m[i]);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = lane + 32 * i;
      if (p < PARTS) {
        const float f = m[i] == -INFINITY ? 0.f : expf(m[i] - mx);
        wts[h * PARTS + p] = f;
        l += recv_ml[p * 2 * HM + HM + h] * f;
      }
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) l += __shfl_xor_sync(0xffffffffu, l, sh);
    if (lane == 0) wts[HM * PARTS + h] = l > 0.f ? 1.f / l : 0.f;   // 1 / l
    if constexpr (PART)
      if (lane == 0 && rank == 0)
        lse[(size_t)b * Hq + h0 + h] = l > 0.f ? mx + logf(l) : -INFINITY;
  }
  __syncthreads();
  const int e0 = rank * per, e1 = imin(total, e0 + per);
  for (int e = e0 + tid; e < e1; e += THREADS) {
    const int h = e / D;
    const float* w = wts + h * PARTS;
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < PARTS; ++p) s = fmaf(recv[(size_t)p * L.slice + e - e0], w[p], s);
    attn::store1(o + ((size_t)b * Hq + h0) * D + e, s * wts[HM * PARTS + h]);
  }
}

template <typename T, bool PART, int W, int H, int WR, int TC = 0>
int launch_with(const void* q, const void* k, const void* v, const int* lengths, void* o,
                float* lse, int N, int Hq, int Hkv, int S, int D, float scale,
                const Layout& L, cudaStream_t stream) {
  using O = typename std::conditional<PART, float, T>::type;
  const size_t smem = L.bytes;
  auto kernel = decode_kernel<T, W, H, WR, TC, PART>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.cl, Hkv * cdiv(Hq / Hkv, HEADS), N);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), lengths, static_cast<O*>(o), lse, Hq, Hkv,
                           S, D, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool PART>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o, float* lse,
           int N, int Hq, int Hkv, int S, int D, float scale, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const Layout L(D, (int)sizeof(T), rep);
  if (L.bytes > 227 * 1024 || (long long)Hkv * cdiv(rep, HEADS) > 65535)
    return (int)cudaErrorInvalidValue;
  if (rep == 1)
    return launch_with<T, PART, 4, 1, 8>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, L,
                                         stream);
  if (L.warps == 4)
    return launch_with<T, PART, 4, HEADS, 8>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale,
                                             L, stream);
  if (L.wrows == 8)
    return launch_with<T, PART, 8, HEADS, 8>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale,
                                             L, stream);
  if constexpr (sizeof(T) == 2) {         // p v on the tensor cores
    if (tc_dim(D, 2, rep) == 128)
      return launch_with<T, PART, 8, HEADS, 16, 128>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D,
                                                     scale, L, stream);
  }
  return launch_with<T, PART, 8, HEADS, 16>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, L,
                                            stream);
}

template <bool PART>
int launch_dtype(const void* q, const void* k, const void* v, const int* lengths, void* o,
                 float* lse, int N, int Hq, int Hkv, int S, int D, float scale, int dtype,
                 cudaStream_t stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D * elt % 16 != 0 || D > 256 || N > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float, PART>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, PART>(q, k, v, lengths, o, lse, N, Hq, Hkv, S, D, scale,
                                       stream);
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
