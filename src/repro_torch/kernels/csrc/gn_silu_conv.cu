// Fused GroupNorm + SiLU + 3x3 SAME convolution on the H100's tensor cores:
// an implicit GEMM in 3xTF32 on mma.sync.m16n8k8.
//
// Replaces src/repro/kernels/gn_silu_conv.py::gn_silu_conv3x3
// (_fused_kernel), the decoder's res-block hot path.  The per-(n, group)
// statistics come first from gn_stats.cu.
//
// Bound on the H100: operations.  At the decoder's widths (Cin, Cout of
// 128-512) a 3x3 conv does 9 * Cin MACs per output element against a few
// bytes.  The card's peaks: 67 TFLOP/s in fp32 on the CUDA cores, 495 in
// TF32 on the tensor cores (165 for the three passes of 3xTF32).  One TF32
// pass keeps about 11 bits of each product, too few for the decode's 1e-4
// conv tolerance and its uint8 +-1 LSB gate; 3xTF32 keeps about 22: each
// fp32 operand is carried as hi = tf32(x) and lo = tf32(x - hi), and a
// product sums lo*hi + hi*lo + hi*hi into fp32 accumulators.
//
// Design.  GEMM shape: M = a block's 128 output pixels (4 rows x 32), N = a
// 128-wide Cout tile, K = 9 taps x Cin walked as (16-channel chunk, tap
// row, tap column), one tap of one chunk per step.  Eight warps, 2 along M
// x 4 along N, each own 64 pixels x 32 channels (4 x 4 m16n8 tiles), two
// blocks per SM; where the grid fits the SMs once over (a single 64 x 64
// latent) a block has sixteen warps, 2 x 8, each 64 pixels x 16 channels.
// One block barrier per step.  A pixel's place in its m16 tile and every
// sum's order are the same in both, so they give the same bits and a
// batch's images are independent of how many share the launch.
//   Weights: each step's [16 x 128] fp32 slice comes by cp.async into a
//   ring of three stages, issued two steps ahead, and is split into hi and
//   lo as its fragments are loaded.  (Splitting it in device memory first
//   doubles the bytes each step moves; splitting it once per step by the
//   whole block costs a stage of shared memory and a pass: both measured
//   slower.)
//   Prologue: the input halo of a chunk (6 x 34 pixels x 16 channels) is
//   loaded once, normalised (GroupNorm + affine), activated (SiLU, with
//   the special-function unit's exp and reciprocal), set to zero outside
//   the image AFTER the activation (the SAME padding ring:
//   silu(gn(0)) != 0), split into hi and lo planes and kept in shared
//   memory.  Two halo buffers: the next chunk's halo is staged a ninth per
//   step during this chunk's nine steps, beside that step's products.
//   (Issuing its loads before the products and its stores after them, or
//   copying it raw by cp.async two steps ahead, measured slower on the H100:
//   both cost registers or instructions the products need.)
//   The A fragment of tap (ry, cx) is read from the halo at a shifted
//   offset: there is no im2col buffer.
//   Bank conflicts: every plane's row stride is 8 mod 32 words, so the
//   eight pixels (or channels) by four k-slots of a fragment load hit 32
//   distinct banks.  No ldmatrix (it has no 32-bit form).
//   Epilogue: bias added; neighbouring lanes swap halves of their m16n8
//   fragments so each thread stores four consecutive channels as a float4.
// Determinism: one block per (image, pixel tile, Cout tile), a fixed K
// order, no split-K: each image's result is independent of the batch.
//
// Weights in their storage type (the TPU kernel's quantized operand forms,
// gn_silu_conv.py:77, 132-138): fp32, bf16, or int8 codes with a per-Cout
// scale.  The raw rows come through the same cp.async ring (16 bytes carry
// 4, 8 or 16 weights).  bf16 values and int8 codes (|q| <= 127) are exact
// in TF32, so a weight's lo half would be zero: its B fragment is the
// value's fp32 bits, with no split, and each product takes two TF32 MMAs
// (a_hi b + a_lo b, tc::mma_2xtf32) instead of three.  The dropped
// a_hi b_lo product is exactly zero, so the result is the bit pattern the
// fp32 path gives for the same weight values.  The scale multiplies each
// output channel's fp32 sum in the epilogue, before the bias.
//
// Cout <= 4 (no main-path caller) keeps the narrow CUDA-core tile of
// conv_tile.cuh: a matrix tile 128 channels wide would be 97 % idle.

#include "conv_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int TH = 4, TW = 32, BN = 128, BK = 16, STAGES = 3;
constexpr int HWD = TW + 2;                   // halo columns
constexpr int HPIX = (TH + 2) * HWD;          // halo pixels
constexpr int PLANE = 232;                    // >= HPIX, 8 mod 32 words
constexpr int HALO_WORDS = 2 * BK * PLANE;    // one halo buffer, hi and lo

// one weight stage of WT: BK rows of BN weights at a row stride of RS
// weights, a multiple of 16 bytes, 8 mod 32 words for fp32 and 4 mod 32
// for bf16 and int8 (a fragment load's 4 rows by 8 columns then hit
// distinct banks, or share a word)
template <class WT>
struct Stage {
  static constexpr int VEC = 16 / (int)sizeof(WT);   // weights per 16 bytes
  static constexpr int RS = BN + (VEC > 8 ? VEC : 8);
  static constexpr int ELEMS = BK * RS;
  static constexpr int SMEM_BYTES = 2 * HALO_WORDS * 4 + STAGES * ELEMS * (int)sizeof(WT);
};

// V4: Cin % 4 == 0, Cout a multiple of 16 bytes of weights, and 16-byte
// aligned x, w, gamma and beta: the halo is read four channels at a time
// and the weights copied 16 bytes at a time; else one value at a time
// WT: the weight's storage type (float, rt::bf16w, int8_t)
// NT threads: warps 2 along M (2 rows of the tile each) x NT / 64 along N
// (4 or 8: 32 or 16 channels each)
template <int V4, int NT, class WT>
__global__ void __launch_bounds__(NT, 512 / NT)
gn_silu_conv_kernel(rt::ConvArgs a) {
  constexpr bool F32 = sizeof(WT) == 4;
  constexpr int RS = Stage<WT>::RS, W_ELEMS = Stage<WT>::ELEMS;
  constexpr int THREADS = NT, MW = 2;                  // warps along M
  constexpr int NWN = NT / 32 / MW;                    // warps along N: 4 or 8
  constexpr int NTW = BN / 8 / NWN;                    // n8 tiles per warp: 4 or 2
  constexpr int MT = TH * TW / (16 * MW);              // m16 tiles per warp: 2 per row
  constexpr int WR = TH / MW;                          // output rows per warp
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* const halo = sm;                           // [2][hi, lo][BK][PLANE]
  WT* const wst = reinterpret_cast<WT*>(sm + 2 * HALO_WORDS);  // [STAGES][BK][RS]
  const WT* const w = static_cast<const WT*>(a.w);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / NWN, wn = warp % NWN;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN, img = blockIdx.z;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, cpg = Cin / a.G;
  const float* __restrict__ x = a.x + (size_t)img * H * W * Cin;
  const size_t wn_elems = (size_t)9 * Cin * Cout;
  const int chunks = (Cin + BK - 1) / BK, steps = chunks * 9;

  // the weights of step s (chunk s / 9, tap s % 9) into its stage
  auto copy_weights = [&](int s) {
    const int ck = (s / 9) * BK, tap = s % 9;
    WT* dst = wst + (s % STAGES) * W_ELEMS;
    constexpr int VEC = V4 ? Stage<WT>::VEC : 1;
    for (int e = tid; e < BK * BN / VEC; e += THREADS) {
      const int kk = e / (BN / VEC), nn = (e % (BN / VEC)) * VEC;
      const int c = ck + kk, co = n0 + nn;
      const bool ok = c < Cin && co < Cout;
      const WT* src = ok ? w + ((size_t)tap * Cin + c) * Cout + co : w;
      if (V4) tc::cp_async16(dst + kk * RS + nn, src, ok);
      else if (F32) tc::cp_async4(dst + kk * RS + nn, src, ok);
      // a 1- or 2-byte weight has no cp.async: a plain store, which the
      // barrier before its step makes visible like the copies
      else dst[kk * RS + nn] = ok ? *src : WT{};
    }
  };

  // GroupNorm + affine + SiLU of x at halo pixel pix, channel c (0 outside
  // the image or past Cin), split into the hi/lo planes of buffer buf
  auto put = [&](uint32_t* buf, int k, int pix, float v) {
    const tc::Split p = tc::split_tf32(v);
    buf[k * PLANE + pix] = p.hi;
    buf[BK * PLANE + k * PLANE + pix] = p.lo;
  };
  const float2* const stats = reinterpret_cast<const float2*>(a.stats) + img * a.G;
  auto act = [&](float xv, float2 st, float gamma, float beta) {
    const float u = fmaf((xv - st.x) * st.y, gamma, beta);
    return __fdividef(u, 1.f + __expf(-u));   // u * sigmoid(u); -0 for u -> -inf
  };
  // the halo of chunk ch as ITEMS items (GROUP channels at one pixel each),
  // pixel index fastest; item e's raw input, or zeros outside the image
  constexpr int GROUP = V4 ? 4 : 1;
  constexpr int ITEMS = (BK / GROUP) * HPIX;
  constexpr int PER_STEP = (ITEMS / 9 + THREADS) / THREADS;   // items a thread stages per step
  auto load_item = [&](int ch, int e) {
    const int cg = e / HPIX, pix = e % HPIX;
    const int gy = y0 + pix / HWD - 1, gx = x0 + pix % HWD - 1, c = ch * BK + cg * GROUP;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
      const float* px = x + ((size_t)gy * W + gx) * Cin + c;
      if (V4) v = __ldg(reinterpret_cast<const float4*>(px));
      else v.x = __ldg(px);
    }
    return v;
  };
  // ... activated, split and stored into halo buffer ch & 1
  auto store_item = [&](int ch, int e, float4 v) {
    uint32_t* buf = halo + (ch & 1) * HALO_WORDS;
    const int cg = e / HPIX, pix = e % HPIX;
    const int gy = y0 + pix / HWD - 1, gx = x0 + pix % HWD - 1, c = ch * BK + cg * GROUP;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
    if (V4) {
      if (in) {
        const float4 ga = __ldg(reinterpret_cast<const float4*>(a.gamma + c));
        const float4 be = __ldg(reinterpret_cast<const float4*>(a.beta + c));
        // one group for the four channels unless C / G is not a multiple of 4
        const float2 s0 = __ldg(stats + c / cpg);
        const bool one = cpg % 4 == 0;
        const float2 s1 = one ? s0 : __ldg(stats + (c + 1) / cpg);
        const float2 s2 = one ? s0 : __ldg(stats + (c + 2) / cpg);
        const float2 s3 = one ? s0 : __ldg(stats + (c + 3) / cpg);
        v = make_float4(act(v.x, s0, ga.x, be.x), act(v.y, s1, ga.y, be.y),
                        act(v.z, s2, ga.z, be.z), act(v.w, s3, ga.w, be.w));
      }
      put(buf, 4 * cg, pix, v.x);
      put(buf, 4 * cg + 1, pix, v.y);
      put(buf, 4 * cg + 2, pix, v.z);
      put(buf, 4 * cg + 3, pix, v.w);
    } else {
      put(buf, cg, pix,
          in ? act(v.x, __ldg(stats + c / cpg), __ldg(a.gamma + c), __ldg(a.beta + c)) : 0.f);
    }
  };

  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_weights(0);
  tc::cp_async_commit();
  if (steps > 1) copy_weights(1);
  tc::cp_async_commit();
  for (int e = tid; e < ITEMS; e += THREADS) store_item(0, e, load_item(0, e));

  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<1>();  // this step's weights (the next step's may be in flight)
    __syncthreads();         // ... for every thread; step s-1's reads are done
    if (s + 2 < steps) copy_weights(s + 2);
    tc::cp_async_commit();   // one group per step, empty at the end
    const int ch = s / 9, tap = s % 9, ry = tap / 3, cx = tap % 3;
    // a ninth of the next chunk's halo
    const bool next = ch + 1 < chunks;
    const int e0 = tap * ITEMS / 9 + tid, e1 = (tap + 1) * ITEMS / 9;
#pragma unroll
    for (int i = 0; i < PER_STEP; ++i)
      if (next && e0 + i * THREADS < e1)
        store_item(ch + 1, e0 + i * THREADS, load_item(ch + 1, e0 + i * THREADS));

    const uint32_t* const Ah = halo + (ch & 1) * HALO_WORDS;
    const uint32_t* const Al = Ah + BK * PLANE;
    const WT* const Wf = wst + (s % STAGES) * W_ELEMS;
    // each 8-deep step in a fresh fragment, then added with round-to-nearest
    // (the same for both tile heights, so they give the same bits)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int ib = (kk + t) * RS + wn * 8 * NTW + nt * 8 + g;
        if constexpr (F32) {
          const tc::Split b0 = tc::split_tf32(rt::to_f32(Wf[ib]));
          const tc::Split b1 = tc::split_tf32(rt::to_f32(Wf[ib + 4 * RS]));
          bh[nt][0] = b0.hi;
          bh[nt][1] = b1.hi;
          bl[nt][0] = b0.lo;
          bl[nt][1] = b1.lo;
        } else {
          // exact in TF32: the fp32 bits are the operand, lo is zero
          bh[nt][0] = __float_as_uint(rt::to_f32(Wf[ib]));
          bh[nt][1] = __float_as_uint(rt::to_f32(Wf[ib + 4 * RS]));
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = WR * wm + mt / 2, col = (mt % 2) * 16 + g;
        const int ia = (kk + t) * PLANE + (row + ry) * HWD + col + cx;
        const uint32_t ah[4] = {Ah[ia], Ah[ia + 8], Ah[ia + 4 * PLANE], Ah[ia + 4 * PLANE + 8]};
        const uint32_t al[4] = {Al[ia], Al[ia + 8], Al[ia + 4 * PLANE], Al[ia + 4 * PLANE + 8]};
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          if constexpr (F32) tc::mma_3xtf32(acc[mt][nt], ah, al, bh[nt], bl[nt]);
          else tc::mma_2xtf32(acc[mt][nt], ah, al, bh[nt]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  // -- epilogue: bias, four consecutive channels per thread, float4 stores --
  const bool even = (t & 1) == 0;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = y0 + WR * wm + mt / 2;
    const int xx = x0 + (mt % 2) * 16 + g + (even ? 0 : 8);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float* c = acc[mt][nt];
      // even lanes take pixel g's pair from the odd neighbour, odd lanes
      // pixel g+8's from the even one
      const float px = __shfl_xor_sync(0xffffffffu, even ? c[2] : c[0], 1);
      const float py = __shfl_xor_sync(0xffffffffu, even ? c[3] : c[1], 1);
      const int cb = n0 + wn * 8 * NTW + nt * 8 + 2 * (t & ~1);
      float v[4] = {c[0], c[1], px, py};
      if (!even) {
        v[0] = px;
        v[1] = py;
        v[2] = c[2];
        v[3] = c[3];
      }
      if (y >= H || xx >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = cb + j < Cout;
        if (rt::Scaled<WT>::value) v[j] = __fmul_rn(v[j], in ? __ldg(a.wscale + cb + j) : 0.f);
        v[j] += in ? __ldg(a.bias + cb + j) : 0.f;
      }
      float* o = out + (((size_t)img * H + y) * W + xx) * Cout + cb;
      if ((Cout & 3) == 0 && cb + 3 < Cout) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (cb + j < Cout) o[j] = v[j];
      }
    }
  }
}

template <int V4, int NT, class WT>
int launch_tile(const rt::ConvArgs& a, cudaStream_t stream) {
  constexpr int SMEM_BYTES = Stage<WT>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(gn_silu_conv_kernel<V4, NT, WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW), (a.Cout + BN - 1) / BN, a.N);
  gn_silu_conv_kernel<V4, NT, WT><<<grid, NT, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

// 16 warps per block where the grid fits the SMs once over (one 64 x 64
// latent: 128 blocks), else 8 warps and two blocks per SM
template <int V4, class WT>
int launch(const rt::ConvArgs& a, cudaStream_t stream) {
  const int sms = tc::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long blocks =
      (long)a.N * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW) * ((a.Cout + BN - 1) / BN);
  return blocks <= sms ? launch_tile<V4, 512, WT>(a, stream) : launch_tile<V4, 256, WT>(a, stream);
}

template <class WT>
int launch_typed(const rt::ConvArgs& a, cudaStream_t stream) {
  if (rt::Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  if (a.Cout <= 4) return rt::launch_conv_tile<rt::NarrowCfg, 1, 0, 0, WT>(a, stream);
  const bool v4 = a.Cin % 4 == 0 && a.Cout % Stage<WT>::VEC == 0 &&
                  (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                   reinterpret_cast<uintptr_t>(a.gamma) | reinterpret_cast<uintptr_t>(a.beta)) % 16 == 0;
  return v4 ? launch<1, WT>(a, stream) : launch<0, WT>(a, stream);
}

}  // namespace

// x [N, H, W, Cin], stats [N, G, 2] (mean, rstd), gamma/beta [Cin], w [3, 3,
// Cin, Cout] in its storage type wtype (0 fp32, 1 bf16, 2 int8 with wscale
// [Cout]), b [Cout], out [N, H, W, Cout]; the rest fp32; all contiguous.
extern "C" int gn_silu_conv3x3_launch(const float* x, const float* stats, const float* gamma,
                                      const float* beta, const void* w, const float* wscale,
                                      const float* b, float* out, int N, int H, int W, int Cin,
                                      int Cout, int G, int wtype, cudaStream_t stream) {
  rt::ConvArgs a{x, stats, gamma, beta, w, wscale, b, out, N, H, W, Cin, Cout, G};
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || N > 65535 || G <= 0 ||
      Cin % G != 0)
    return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case rt::kF32: return launch_typed<float>(a, stream);
    case rt::kBF16: return launch_typed<rt::bf16w>(a, stream);
    case rt::kI8: return launch_typed<int8_t>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}
