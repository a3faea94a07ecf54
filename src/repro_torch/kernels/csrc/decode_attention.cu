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
// q heads of its kv head (the point of the Pallas kernel's grouping), and
// about 4 * rep * d FLOPs are spent per row of 2 * d elements.  Design: the
// (sequence, kv head) pairs are few (16 for Qwen2-7B at batch 4 against 132
// SMs), so the cache is also split along S into chunks of CHUNK = 64 rows,
// one block per (chunk, kv head, sequence); a chunk at or past the
// sequence's length exits at once, so reading stops at lengths[b].  What
// bounds one block is latency, not bandwidth, so its steps are kept short
// and free of serial reductions.  Scores: each of the 128 threads takes one
// row and one half of d and runs the dot products for up to 8 q heads in
// registers (q broadcast from shared memory); the two halves are added in
// a fixed order.  The chunk's scores stay in shared memory, so its softmax
// max is exact.  p v: warp w takes rows w, w + 4, ..., eight rows in
// flight, its lanes each on 4 consecutive columns (one 8- or 16-byte load;
// a warp covers 128 columns per load), accumulating up to 8 q heads in
// registers; the 4 warps' sums are added in a fixed order.  A second launch
// merges the chunks' (max, sum, acc) of each (sequence, q head) in chunk
// order.  No atomics: a row's result depends only on its own length and
// data, not on the batch or on S.

#include "attn_common.cuh"

namespace {

using attn::load4;

constexpr int CHUNK = 64;      // cache rows per block
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int GROUP = 8;       // q heads held in registers together
constexpr int UNROLL = 8;      // cache rows each warp has in flight in p v
static_assert(THREADS == 2 * CHUNK, "one thread per (row, half of d)");

// NT: 128-column passes over a row in p v (d <= 128 * NT)
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
dec_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ part_ml, float* __restrict__ part_acc,
                 int Hq, int Hkv, int S, int D, int splits, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int rep = Hq / Hkv;
  float* qs = smem;                       // [rep][D]        q, fp32
  float* sc = qs + rep * D;               // [2][rep][CHUNK] half dots; p
  float* red = sc + 2 * rep * CHUNK;      // [WARPS][GROUP][D] warp sums

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int len = min(max(lengths[b], 0), S);
  const int s0 = split * CHUNK;
  if (s0 >= len) return;                  // the merge reads chunks < len only
  const int cnt = min(CHUNK, len - s0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h0 = g * rep;                 // first q head of this kv head
  const T* Kb = k + (((size_t)b * Hkv + g) * S + s0) * D;
  const T* Vb = v + (((size_t)b * Hkv + g) * S + s0) * D;
  const T* Qb = q + ((size_t)b * Hq + h0) * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < rep * D / 4; e += THREADS)
    *reinterpret_cast<float4*>(qs + 4 * e) = load4(Qb + 4 * e);
  __syncthreads();

  // -- scores: thread (half, row) dots one half of its row with GROUP heads --
  {
    const int row = tid % CHUNK, half = tid / CHUNK;
    const int n4 = D / 4, h4 = (n4 + 1) / 2;
    const int c4_lo = half * h4, c4_hi = min(n4, c4_lo + h4);
    const T* kr = Kb + (size_t)row * D;
    for (int r0 = 0; r0 < rep; r0 += GROUP) {
      float dot[GROUP];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) dot[r] = 0.f;
      if (row < cnt) {
#pragma unroll 4
        for (int c4 = c4_lo; c4 < c4_hi; ++c4) {
          const float4 ka = load4(kr + 4 * c4);
#pragma unroll
          for (int r = 0; r < GROUP; ++r) {
            if (r0 + r < rep) {
              const float4 qa =
                  *reinterpret_cast<const float4*>(qs + (r0 + r) * D + 4 * c4);
              dot[r] = fmaf(qa.x, ka.x, dot[r]);
              dot[r] = fmaf(qa.y, ka.y, dot[r]);
              dot[r] = fmaf(qa.z, ka.z, dot[r]);
              dot[r] = fmaf(qa.w, ka.w, dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < GROUP; ++r)
        if (r0 + r < rep) sc[(half * rep + r0 + r) * CHUNK + row] = dot[r];
    }
  }
  __syncthreads();

  // -- the chunk's softmax per q head: max, exp, sum ---------------------------
  float* ml = part_ml + (((size_t)b * Hq + h0) * splits + split) * 2;
  for (int r = warp; r < rep; r += WARPS) {
    float* s_r = sc + r * CHUNK;
    const float* s_hi = sc + (rep + r) * CHUNK;
    float mx = -INFINITY;
    for (int j = lane; j < cnt; j += 32) {
      s_r[j] = (s_r[j] + s_hi[j]) * scale;
      mx = fmaxf(mx, s_r[j]);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    float sum = 0.f;
    for (int j = lane; j < cnt; j += 32) {
      const float p = expf(s_r[j] - mx);
      s_r[j] = p;
      sum += p;
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, sh);
    if (lane == 0) {
      ml[(size_t)r * splits * 2] = mx;
      ml[(size_t)r * splits * 2 + 1] = sum;
    }
  }
  __syncthreads();

  // -- p v for GROUP q heads at a time; each warp over its rows ----------------
  for (int r0 = 0; r0 < rep; r0 += GROUP) {
    float acc[GROUP][NT][4];
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][t][c] = 0.f;
    for (int j0 = warp; j0 < cnt; j0 += WARPS * UNROLL) {
      float4 vr[UNROLL][NT];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = j0 + u * WARPS, c = 4 * lane + 128 * t;
          vr[u][t] = (j < cnt && c < D) ? load4(Vb + (size_t)j * D + c) : zero4;
        }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * WARPS;
        if (j >= cnt) break;
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          if (r0 + r < rep) {
            const float p = sc[(r0 + r) * CHUNK + j];
#pragma unroll
            for (int t = 0; t < NT; ++t) {
              acc[r][t][0] = fmaf(p, vr[u][t].x, acc[r][t][0]);
              acc[r][t][1] = fmaf(p, vr[u][t].y, acc[r][t][1]);
              acc[r][t][2] = fmaf(p, vr[u][t].z, acc[r][t][2]);
              acc[r][t][3] = fmaf(p, vr[u][t].w, acc[r][t][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = 4 * lane + 128 * t;
        if (r0 + r < rep && c < D)
          *reinterpret_cast<float4*>(red + ((size_t)warp * GROUP + r) * D + c) =
              make_float4(acc[r][t][0], acc[r][t][1], acc[r][t][2], acc[r][t][3]);
      }
    __syncthreads();
    const int nr = min(GROUP, rep - r0);
    for (int e = tid; e < nr * D; e += THREADS) {
      const int r = e / D, c = e % D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[((size_t)w * GROUP + r) * D + c];
      part_acc[(((size_t)b * Hq + h0 + r0 + r) * splits + split) * D + c] = s;
    }
    __syncthreads();
  }
}

// One block per (sequence, q head): merge the chunks below the length in
// chunk order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dec_merge_kernel(const float* __restrict__ part_ml,
                 const float* __restrict__ part_acc,
                 const int* __restrict__ lengths, T* __restrict__ o, int Hq,
                 int S, int D, int splits) {
  const int bh = blockIdx.x, b = bh / Hq;
  const int len = min(max(lengths[b], 0), S);
  const int nchunk = (len + CHUNK - 1) / CHUNK;
  const float* ml = part_ml + (size_t)bh * splits * 2;
  const float* pa = part_acc + (size_t)bh * splits * D;
  float mx = -INFINITY;
  for (int c = 0; c < nchunk; ++c) mx = fmaxf(mx, ml[2 * c]);
  float l = 0.f;
  for (int c = 0; c < nchunk; ++c) l += ml[2 * c + 1] * expf(ml[2 * c] - mx);
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c)
      acc = fmaf(pa[(size_t)c * D + d], expf(ml[2 * c] - mx), acc);
    attn::store1(o + (size_t)bh * D + d, acc * inv);
  }
}

template <typename T, int NT>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* part_ml, float* part_acc, int N, int Hq, int Hkv,
           int S, int D, int splits, float scale, cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const size_t smem = sizeof(float) * ((size_t)rep * D +
                                       (size_t)2 * rep * CHUNK +
                                       (size_t)WARPS * GROUP * D);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dec_chunk_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dec_chunk_kernel<T, NT><<<dim3(splits, Hkv, N), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_ml, part_acc, Hq, Hkv, S, D,
      splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dec_merge_kernel<T><<<N * Hq, THREADS, 0, stream>>>(
      part_ml, part_acc, lengths, static_cast<T*>(o), Hq, S, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// q [N, Hq, D], k/v caches [N, Hkv, S, D], lengths [N] int32, o [N, Hq, D],
// contiguous, q/k/v/o of one type: dtype 0 = fp32, 1 = bf16.  Scratch
// part_ml [N, Hq, splits, 2] and part_acc [N, Hq, splits, D] fp32, with
// splits = ceil(S / chunk rows).  D % 4 == 0, D <= 256, Hq % Hkv == 0.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* o, float* part_ml,
                                       float* part_acc, int N, int Hq, int Hkv,
                                       int S, int D, int splits, float scale,
                                       int dtype, cudaStream_t stream) {
  if (N <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || D <= 0 ||
      D % 4 != 0 || D > 256 || splits != (S + CHUNK - 1) / CHUNK ||
      splits > 65535 || Hkv > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const bool wide = D > 128;              // two 128-column passes in p v
  if (dtype == 0)
    return wide ? launch<float, 2>(q, k, v, lengths, o, part_ml, part_acc, N,
                                   Hq, Hkv, S, D, splits, scale, stream)
                : launch<float, 1>(q, k, v, lengths, o, part_ml, part_acc, N,
                                   Hq, Hkv, S, D, splits, scale, stream);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 2>(q, k, v, lengths, o, part_ml,
                                           part_acc, N, Hq, Hkv, S, D, splits,
                                           scale, stream)
                : launch<__nv_bfloat16, 1>(q, k, v, lengths, o, part_ml,
                                           part_acc, N, Hq, Hkv, S, D, splits,
                                           scale, stream);
  return (int)cudaErrorInvalidValue;
}
