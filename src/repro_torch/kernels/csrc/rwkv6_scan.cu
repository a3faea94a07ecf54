// RWKV-6 (Finch) linear-attention recurrence, per (sequence, head) pair:
//
//   out_t = r_t . (S + u (x) (k_t (x) v_t)),   S <- diag(exp(-exp(w_t))) S + k_t (x) v_t
//
// with the [d, d] state S in fp32 (row i = key, column j = value).  r/k/v
// fp32 or bf16, w and u fp32, the output in r's type (bf16 rounded to
// nearest even), the final state fp32.
//
// Replaces src/repro/kernels/rwkv6_scan.py::rwkv6_scan (_rwkv_kernel), the
// time mix of every RWKV-6 layer (the JAX model reaches the same function
// through its chunked XLA form, models/ssm.py::rwkv6_chunked, whose
// factoring the prefill kernel below brings onto the tensor cores).
//
// Two kernels, chosen by the wrapper from the token count alone.
//
// rwkv6_chunk_kernel (the prefill).  Bound on the H100: its bytes (r, k, v,
// w read once, the output written once) once its d^2 work runs on the
// tensor cores.  A block owns one pair and a tile of NT value columns (NT =
// 64 at d = 64: one block per pair, 256 blocks at rwkv6-7b's prefill) and
// keeps its [d x NT] slice of S in fp32 registers for the whole sequence,
// walking the tokens in sub-chunks of C = 16.  With dec = exp(-exp(w)) and, inside a sub-chunk, D_t the product
// of dec over tokens < t (= exp(Lp_t - L_start) of rwkv6_chunked), each
// sub-chunk is
//
//   y_t  = (r_t (.) D_t) S                                   inter, on the MMA
//        + sum_{s<t} A_ts v_s + A_tt v_t                      intra, on the MMA
//   A_ts = sum_i r_ti k_si prod_{s<m<t} dec_mi  (s < t),   A_tt = sum_i r_ti u_i k_ti
//   S   <- D_16 (.)rows S + (k (.) prod_{m>s} dec_m)^T v     state, on the MMA
//
// Every decay factor is a product of decays (each <= 1) between two tokens
// of the sub-chunk, formed pair by pair on the CUDA cores: nothing can
// overflow however strong the decay, a factor underflows only where the true
// product does, and no exponential is taken beyond dec itself (the exact
// pairwise block costs 120 d multiplies per sub-chunk, not 120 d exp).
// The three products run in 3xTF32 on mma.sync.m16n8k8 (hopper_mma.cuh): S
// is held transposed, S^T [NT x d], as the accumulator of the state product,
// and that same fragment is the A operand of y^T = S^T (r (.) D)^T with the
// k index permuted within each 8-wide slice (the accumulator's column pair
// 2t, 2t+1 read as the A fragment's k = t, t + 4; the B operand is read in
// the same order), so S never leaves the registers.  Two warps own each 16
// value columns, one per half of the keys (8 warps at d = 64): each holds
// its half of S^T, and adds the inter term over its keys and the intra term
// over its 8 tokens s to its part of y; the two parts are added in a fixed
// order as the output is stored, 16 bytes a thread.  The sub-chunk's
// CUDA-core work is done once per block between barriers: dec and fp32
// copies of r, k, v; the two decay scans, a thread per key column; A, a
// warp per pair of rows s and 15 - s (15 pairs (t, s), each lane d / 32 key
// columns, the 15 sums reduced over the lanes by a fixed-order
// reduce-scatter), and its diagonal.  The next sub-chunk's r, k, v, w are
// staged with cp.async while the current one computes.  Tokens past t are
// padded with r = k = v = 0 and dec = 1, which leaves S exactly unchanged;
// key rows and value columns past d are zero.
//
// rwkv6_decode_kernel (a decode step, t <= DECODE_MAX_T of the wrapper).
// Bound: reading and writing the state.  A block of 8 warps per pair holds
// the whole [d x d] state in registers, 16-byte loads, eight lanes along a
// row so a warp reads four whole 128-byte rows at once, each thread 4 x 4
// values at d = 64; out_j = sum_i r_i S_ij is summed over the rows by warp
// shuffles and then over the warps' row groups through shared memory, both
// in a fixed order; the next token's inputs are loaded while one computes.
//
// Both kernels: every block reads its elements of the initial state before
// it writes the same elements of the final state, and no two threads share
// an element, so the final state may alias the initial one (decode updates
// its cache in place).  A pair's arithmetic does not depend on which block
// runs it or on the other pairs: results are independent of the batch.

#include "rwkv6_chunk.cuh"

namespace {

// ---------------------------------------------------------------------------
// decode: the whole state of one pair in the registers of 8 warps
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;

// VEC = 4: 16-byte state rows (d % 4 == 0), 8 lanes along a row; VEC = 1:
// one value per lane, 32 lanes along a row.  DP (32, 64, 128) covers d; a
// warp owns 32 columns and every (8 / (DP / 32))-th group of rows.
template <typename T, int VEC, int DP>
__global__ void __launch_bounds__(DEC_THREADS)
rwkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const float* __restrict__ u, const float* s0,
                    T* __restrict__ out, float* sT, int H, int Tn, int D) {
  constexpr int NCB = DP / 32;             // 32-column blocks
  constexpr int RG = 8 / NCB;              // row groups (warps per column block)
  constexpr int IR = VEC == 4 ? 4 : 1;     // rows per warp and sweep
  constexpr int JQ = 32 / IR;              // lanes along a row
  constexpr int RS = RG * IR;              // rows per sweep
  constexpr int M = DP / RS;               // rows per thread
  constexpr int NB = DP / 32;              // bonus terms per lane of warp 0
  __shared__ float part[2][RG][DP];
  __shared__ float bonus[2];

  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int rg = wp / NCB, ir = lane / JQ;
  const int j0 = (wp % NCB) * 32 + (lane % JQ) * VEC;
  const bool jlive = j0 < D;               // VEC = 4: d % 4 == 0, all four or none
  const int pair = blockIdx.x;
  const size_t sbase = (size_t)pair * D * D;
  const float* up = u + (size_t)(pair % H) * D;

  float S[M][VEC];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = rg * IR + ir + m * RS;
    const bool live = jlive && i < D && s0 != nullptr;
    if constexpr (VEC == 4) {
      const float4 x = live ? *reinterpret_cast<const float4*>(s0 + sbase + (size_t)i * D + j0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      S[m][0] = x.x;
      S[m][1] = x.y;
      S[m][2] = x.z;
      S[m][3] = x.w;
    } else {
      S[m][0] = live ? s0[sbase + (size_t)i * D + j0] : 0.f;
    }
  }

  // what this thread reads of one token: its rows' r, k, w, its columns'
  // v, the bonus lanes' r u and k (warp 0), the v of its output column;
  // the next token's are loaded while this one computes
  struct Tok {
    float r[M], k[M], w[M], v[VEC], br[NB], bk[NB], vo;
  };
  auto fetch = [&](int tok, Tok& x) {
    const size_t row = ((size_t)pair * Tn + tok) * D;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = rg * IR + ir + m * RS;
      const bool ok = i < D;
      x.r[m] = ok ? ld(r + row + i) : 0.f;
      x.k[m] = ok ? ld(k + row + i) : 0.f;
      x.w[m] = ok ? w[row + i] : -INFINITY;   // dec = 1
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) x.v[c] = jlive ? ld(v + row + j0 + c) : 0.f;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int i = lane + 32 * q;
      const bool ok = wp == 0 && i < D;
      x.br[q] = ok ? ld(r + row + i) * up[i] : 0.f;
      x.bk[q] = ok ? ld(k + row + i) : 0.f;
    }
    x.vo = (int)threadIdx.x < D ? ld(v + row + threadIdx.x) : 0.f;
  };
  Tok cur, nxt;
  fetch(0, cur);
  for (int tok = 0; tok < Tn; ++tok) {
    const int b = tok & 1;
    if (tok + 1 < Tn) fetch(tok + 1, nxt);
    float p[VEC] = {};
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float di = expf(-expf(cur.w[m]));
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        p[c] = fmaf(cur.r[m], S[m][c], p[c]);
        S[m][c] = fmaf(di, S[m][c], cur.k[m] * cur.v[c]);
      }
    }
#pragma unroll
    for (int o = JQ; o < 32; o <<= 1)
#pragma unroll
      for (int c = 0; c < VEC; ++c) p[c] += __shfl_xor_sync(0xffffffffu, p[c], o);
    if (ir == 0 && jlive)
#pragma unroll
      for (int c = 0; c < VEC; ++c) part[b][rg][j0 + c] = p[c];
    if (wp == 0) {   // the bonus r . (u (.) k), over the lanes in a fixed order
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < NB; ++q) a = fmaf(cur.br[q], cur.bk[q], a);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) bonus[b] = a;
    }
    __syncthreads();
    const int j = threadIdx.x;
    if (j < D) {
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < RG; ++q) o += part[b][q][j];
      attn::store1(out + ((size_t)pair * Tn + tok) * D + j, fmaf(bonus[b], cur.vo, o));
    }
    cur = nxt;
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = rg * IR + ir + m * RS;
    if (!jlive || i >= D) continue;
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(sT + sbase + (size_t)i * D + j0) =
          make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
    else
      sT[sbase + (size_t)i * D + j0] = S[m][0];
  }
}

template <typename T, int VEC, int DP>
int launch_decode(const void* r, const void* k, const void* v, const float* w, const float* u,
                  const float* s0, void* out, float* sT, int NH, int H, int Tn, int D,
                  cudaStream_t stream) {
  rwkv6_decode_kernel<T, VEC, DP><<<NH, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(out), sT, H, Tn, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
             const float* s0, void* out, float* sT, int NH, int H, int Tn, int D, int decode,
             cudaStream_t stream) {
  if (decode) {
    const bool vec = D % 4 == 0 && aligned16(s0) && aligned16(sT);
#define RWKV_DECODE(DP)                                                                   \
  return vec ? launch_decode<T, 4, DP>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream) \
             : launch_decode<T, 1, DP>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream)
    if (D <= 32) RWKV_DECODE(32);
    if (D <= 64) RWKV_DECODE(64);
    RWKV_DECODE(128);
#undef RWKV_DECODE
  }
  if (D <= 16) return launch_chunk<T, 16>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (D <= 32) return launch_chunk<T, 32>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  if (D <= 64) return launch_chunk<T, 64>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
  return launch_chunk<T, 128>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, stream);
}

}  // namespace

// r, k, v [NH, Tn, D] of one type (dtype 0 = fp32, 1 = bf16), w [NH, Tn, D]
// fp32, u [H, D] fp32 (pair p uses head p % H), s0 [NH, D, D] fp32 or null
// (zeros), out [NH, Tn, D] in r's type, sT [NH, D, D] fp32 (may equal s0);
// all contiguous.  1 <= D <= 128.  decode != 0 runs the decode kernel (the
// wrapper's choice for a few tokens), else the chunked one.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const float* w,
                                 const float* u, const float* s0, void* out, float* sT, int NH,
                                 int H, int Tn, int D, int dtype, int decode,
                                 cudaStream_t stream) {
  if (NH <= 0 || H <= 0 || NH % H != 0 || Tn <= 0 || D <= 0 || D > 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, decode, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, NH, H, Tn, D, decode, stream);
  return (int)cudaErrorInvalidValue;
}
