// The tensor-core convolution tile of conv3x3.cu: an implicit GEMM in
// 3xTF32 on mma.sync.m16n8k8, NHWC fp32 activations, HWIO weights in their
// storage type.  (The fused GN conv and the upsampler run on the
// warpgroup tile of wg_conv_tile.cuh; moving conv3x3's wide path there is
// ROADMAP B 3.)
//
// Why 3xTF32.  The card's peaks: 67 TFLOP/s in fp32 on the CUDA cores,
// 495 in TF32 on the tensor cores (165 for the three passes of 3xTF32).
// One TF32 pass keeps about 11 bits of each product, too few for the
// decode's 1e-4 conv tolerance and its uint8 +-1 LSB gate; 3xTF32 keeps
// about 22: each fp32 operand is carried as hi = tf32(x) and lo = tf32(x -
// hi), and a product sums lo*hi + hi*lo + hi*hi into fp32 accumulators.
//
// GEMM shape: M = a block's 128 output pixels (4 rows x 32), N = a Cout
// tile, K = 9 taps x Cin walked as (16-channel chunk, tap), one tap of one
// chunk per step.
//   Tile  (a template parameter) the Cout tile and warp layout: 128 wide,
//         eight warps (2 along M x 4 along N, each 64 pixels x 32
//         channels), two blocks per SM;
//         128 wide with sixteen warps (2 x 8, each 64 x 16); 64 wide, eight
//         warps (2 x 4, each 64 x 16), twice the blocks of a 128-wide grid;
//         or 32 wide (Cout <= 32), eight warps (4 x 2, each 32 x 16), its K
//         optionally split over a thread block cluster (below).  A pixel's
//         place in its m16 tile, a channel's in its n8 tile and every sum's
//         order are the same in the three wide layouts, so they give the
//         same bits, and a batch's images are independent of how many share
//         the launch.  Which wide layout runs is the launch's `layout`
//         argument (Layout below): 0 is the rule by grid size, the others
//         are what the autotuner (kernels/autotune.py) may pick per shape.
//         In two sweeps of a 64 x 64 latent's decode at buckets 1 and 8
//         (chip_smoke.py phase autotune, H100 80GB HBM3, 700 W) the rule's
//         pick was the fastest at every shape of 0.5 ms or more, by 5-25 %;
//         only the decoder's conv_in at bucket 1 (50 us, a host-timed call)
//         went to the 64-wide tile in one sweep and not in the other.
// One block barrier per step.
//   Weights: each step's [16 x BN] slice comes by cp.async into a ring of
//   three stages, issued two steps ahead, and is split into hi and lo as
//   its fragments are loaded.  (Splitting it in device memory first
//   doubles the bytes each step moves; splitting it once per step by the
//   whole block costs a stage of shared memory and a pass: both measured
//   slower.)
//   Halo: the input halo of a chunk (6 x 34 pixels x 16 channels) is
//   loaded once (zeros outside the image: the SAME padding), split into hi
//   and lo planes and kept in shared memory.  Two halo buffers: the next
//   chunk's halo is staged a ninth per step during this chunk's steps,
//   beside that step's products.  (Issuing its loads before the products
//   and its stores after them, or copying it raw by cp.async
//   two steps ahead, measured slower on the H100 for the fused GN conv:
//   both cost registers or instructions the products need.)  The A
//   fragment of a tap is read from the halo at a shifted offset: there is
//   no im2col buffer.  An 8-deep K slice that lies wholly past Cin (the
//   encoder's Cin = 3, zero-padded to the 16-channel chunk) is skipped:
//   its products are exact zeros, so the sum does not change.
//   Bank conflicts: every plane's row stride is 8 mod 32 words, so the
//   eight pixels (or channels) by four k-slots of a fragment load hit 32
//   distinct banks.  No ldmatrix (it has no 32-bit form).
//   Products: each 8-deep slice is summed in a fresh fragment and then
//   added to the fp32 sum with round-to-nearest (hopper_mma.cuh:
//   mma_3xtf32; the tensor core's own accumulation drifts over long
//   chains); a warp's n8 tiles of one m16 tile issue their chains side by
//   side, which changes no fragment's order.
//   Epilogue: the int8 scale (a rounded multiply), then the bias;
//   neighbouring lanes swap halves of their m16n8 fragments so each thread
//   stores four consecutive channels as a float4.
// K split (the 32-wide tile only; the encoder's conv_out, 512 -> 32 on a
// 64 x 64 latent, is 32 blocks on 132 SMs): the ks blocks of a cluster
// (1, 2, 4 or 8, chosen by the wrapper from H, W, Cin and Cout alone) take
// consecutive shares of the channel chunks.  Each leaves its fp32 sums in
// its shared memory; after one cluster barrier, fragment f of the tile is
// merged by rank f % ks, which reads every rank's sums through distributed
// shared memory and adds them in rank order, and stores it; a second
// barrier keeps every rank's shared memory alive until all have read.  No
// atomics and no scratch in device memory: the result depends on the
// shape, never on the batch.
//
// Weights in their storage type (the TPU kernels' quantized operand
// forms): fp32, bf16, or int8 codes with a per-Cout scale.  The raw rows
// come through the same cp.async ring (16 bytes carry 4, 8 or 16
// weights).  bf16 values and int8 codes are exact in TF32, so a weight's
// lo half would be zero: its B fragment is the value's fp32 bits, with no split, and each product
// takes two TF32 MMAs (a_hi b + a_lo b, tc::mma_2xtf32) instead of three.
// The dropped a_hi b_lo product is exactly zero, so the result is the bit
// pattern the fp32 path gives for the same weight values.

#pragma once

#include <cooperative_groups.h>

#include "conv_tile.cuh"
#include "hopper_mma.cuh"

namespace tcc {

namespace coop = cooperative_groups;

constexpr int TH = 4, TW = 32, BK = 16, STAGES = 3;
constexpr int HWD = TW + 2;                   // halo columns
constexpr int HPIX = (TH + 2) * HWD;          // halo pixels
constexpr int PLANE = 232;                    // >= HPIX, 8 mod 32 words
constexpr int HALO_WORDS = 2 * BK * PLANE;    // one halo buffer, hi and lo
constexpr int MAX_SPLIT = 8;                  // cluster ranks of a K split

// BN output channels per block, NT threads, MW warps along M (the rest
// along N)
template <int BN_, int NT_, int MW_>
struct Tile {
  static constexpr int BN = BN_, NT = NT_, MW = MW_;
  static constexpr int NWN = NT / 32 / MW;    // warps along N
  static constexpr int NTW = BN / 8 / NWN;    // n8 tiles per warp
  static constexpr int WR = TH / MW;          // output rows per warp
  static constexpr int MT = WR * (TW / 16);   // m16 tiles per warp
  static_assert(TH % MW == 0 && NTW >= 1, "warp layout");
};
using Wide = Tile<128, 256, 2>;
using WideOnce = Tile<128, 512, 2>;
using Half = Tile<64, 256, 2>;
using Narrow = Tile<32, 256, 4>;

// The launch's layout codes.  kRule picks kWide8 or kWide16 by grid size;
// kHalf8 is compiled for the vectorised path only (every decode shape is
// vectorised); a code a route does not have is cudaErrorInvalidValue.
enum Layout { kRule = 0, kWide8 = 1, kWide16 = 2, kHalf8 = 3 };

// one weight stage of WT: BK rows of BN weights at a row stride of RS
// weights, a multiple of 16 bytes, 8 mod 32 words for fp32 and 4, 12 or
// 20 mod 32 for 1- and 2-byte weights (a fragment load's 4 rows by 8
// columns then hit distinct banks, or share a word)
template <class WT, int BN>
struct Stage {
  static constexpr int VEC = 16 / (int)sizeof(WT);   // weights per 16 bytes
  static constexpr int RS = BN + (VEC > 8 ? VEC : 8);
  static constexpr int ELEMS = BK * RS;
  static constexpr int SMEM_BYTES = 2 * HALO_WORDS * 4 + STAGES * ELEMS * (int)sizeof(WT);
};

// V4: Cin % 4 == 0, Cout a multiple of 16 bytes of weights, and 16-byte
// aligned x and w: the halo is read four channels at a
// time and the weights copied 16 bytes at a time; else one value at a time.
// SPLIT: the kernel may run as a cluster of ks blocks splitting K.
template <class T, int V4, class WT, bool SPLIT>
__global__ void __launch_bounds__(T::NT, 512 / T::NT)
tc_conv_kernel(rt::ConvArgs a, int ks) {
  constexpr bool F32 = sizeof(WT) == 4;
  constexpr int BN = T::BN, NT = T::NT, NWN = T::NWN, NTW = T::NTW, MT = T::MT, WR = T::WR;
  constexpr int RS = Stage<WT, BN>::RS, W_ELEMS = Stage<WT, BN>::ELEMS;
  constexpr int TAPS = 9;
  static_assert(!SPLIT || MT * NTW * 4 * NT <= 2 * HALO_WORDS, "partial sums fit the halo");
  extern __shared__ __align__(16) uint32_t sm[];
  uint32_t* const halo = sm;                           // [2][hi, lo][BK][PLANE]
  WT* const wst = reinterpret_cast<WT*>(sm + 2 * HALO_WORDS);  // [STAGES][BK][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / NWN, wn = warp % NWN;
  const int rank = SPLIT ? (int)(blockIdx.x % ks) : 0;
  const int tile = SPLIT ? (int)(blockIdx.x / ks) : (int)blockIdx.x;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int y0 = (tile / tiles_w) * TH, x0 = (tile % tiles_w) * TW;
  const int n0 = (int)blockIdx.y * BN, img = blockIdx.z;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const float* __restrict__ x = a.x + (size_t)img * H * W * Cin;
  const WT* const w = static_cast<const WT*>(a.w);
  const int chunks = (Cin + BK - 1) / BK;
  // this block's chunks: all, or its rank's share of a K split
  const int c_lo = SPLIT ? rank * chunks / ks : 0;
  const int c_hi = SPLIT ? (rank + 1) * chunks / ks : chunks;
  const int s_lo = c_lo * TAPS, s_hi = c_hi * TAPS;

  // the weights of step s (chunk s / TAPS, tap s % TAPS) into its stage
  auto copy_weights = [&](int s) {
    const int ck = (s / TAPS) * BK, tap = s % TAPS;
    WT* dst = wst + ((s - s_lo) % STAGES) * W_ELEMS;
    constexpr int VEC = V4 ? Stage<WT, BN>::VEC : 1;
    for (int e = tid; e < BK * BN / VEC; e += NT) {
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

  // the prologue's value at halo pixel pix, channel k of a chunk (0
  // outside the image or past Cin), split into the hi/lo planes of buf
  auto put = [&](uint32_t* buf, int k, int pix, float v) {
    const tc::Split p = tc::split_tf32(v);
    buf[k * PLANE + pix] = p.hi;
    buf[BK * PLANE + k * PLANE + pix] = p.lo;
  };
  // the halo of chunk ch as ITEMS items (GROUP channels at one pixel each),
  // pixel index fastest; item e's raw input, or zeros outside the image
  constexpr int GROUP = V4 ? 4 : 1;
  constexpr int ITEMS = (BK / GROUP) * HPIX;
  constexpr int PER_STEP = (ITEMS / TAPS + NT) / NT;   // items a thread stages per step
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
  // ... through the prologue, split and stored into halo buffer ch & 1
  auto store_item = [&](int ch, int e, float4 v) {
    uint32_t* buf = halo + (ch & 1) * HALO_WORDS;
    const int cg = e / HPIX, pix = e % HPIX;
    if (V4) {
      put(buf, 4 * cg, pix, v.x);
      put(buf, 4 * cg + 1, pix, v.y);
      put(buf, 4 * cg + 2, pix, v.z);
      put(buf, 4 * cg + 3, pix, v.w);
    } else {
      put(buf, cg, pix, v.x);
    }
  };

  float acc[MT][NTW][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  copy_weights(s_lo);
  tc::cp_async_commit();
  if (s_lo + 1 < s_hi) copy_weights(s_lo + 1);
  tc::cp_async_commit();
  for (int e = tid; e < ITEMS; e += NT) store_item(c_lo, e, load_item(c_lo, e));

  for (int s = s_lo; s < s_hi; ++s) {
    tc::cp_async_wait<1>();  // this step's weights (the next step's may be in flight)
    __syncthreads();         // ... for every thread; step s-1's reads are done
    if (s + 2 < s_hi) copy_weights(s + 2);
    tc::cp_async_commit();   // one group per step, empty at the end
    const int ch = s / TAPS, tap = s % TAPS;
    const int ry = tap / 3, cx = tap % 3;   // the tap's halo offset
    // a ninth of the next chunk's halo
    const bool next = ch + 1 < c_hi;
    const int e0 = tap * ITEMS / TAPS + tid, e1 = (tap + 1) * ITEMS / TAPS;
#pragma unroll
    for (int i = 0; i < PER_STEP; ++i)
      if (next && e0 + i * NT < e1)
        store_item(ch + 1, e0 + i * NT, load_item(ch + 1, e0 + i * NT));

    const uint32_t* const Ah = halo + (ch & 1) * HALO_WORDS;
    const uint32_t* const Al = Ah + BK * PLANE;
    const WT* const Wf = wst + ((s - s_lo) % STAGES) * W_ELEMS;
    // each 8-deep slice in a fresh fragment, then added with round-to-nearest
    // (the same for every tile layout, so they give the same bits)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      if (ch * BK + kk >= Cin) continue;   // zero padding past Cin: adds exact zeros
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
        const int row = WR * wm + mt / (TW / 16), col = (mt % (TW / 16)) * 16 + g;
        const int ia = (kk + t) * PLANE + (row + ry) * HWD + col + cx;
        const uint32_t ah[4] = {Ah[ia], Ah[ia + 8], Ah[ia + 4 * PLANE], Ah[ia + 4 * PLANE + 8]};
        const uint32_t al[4] = {Al[ia], Al[ia + 8], Al[ia + 4 * PLANE], Al[ia + 4 * PLANE + 8]};
        if constexpr (F32) tc::mma_3xtf32(acc[mt], ah, al, bh, bl);
        else tc::mma_2xtf32(acc[mt], ah, al, bh);
      }
    }
  }
  tc::cp_async_wait<0>();

  // -- K split: merge the cluster's sums, fragment f by rank f % ks ---------
  if constexpr (SPLIT) {
    if (ks > 1) {
      coop::cluster_group cluster = coop::this_cluster();
      float* const part = reinterpret_cast<float*>(sm);   // [MT * NTW * 4][NT]
      __syncthreads();                                    // the halo's last reads are done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[((mt * NTW + nt) * 4 + e) * NT + tid] = acc[mt][nt][e];
      cluster.sync();                                     // every rank's sums are there
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const int f = mt * NTW + nt;
          if (f % ks != rank) continue;
          float sum[4];
          for (int r = 0; r < ks; ++r) {
            const float* src = cluster.map_shared_rank(part, r) + f * 4 * NT + tid;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = src[e * NT];
              sum[e] = r == 0 ? v : sum[e] + v;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sum[e];
        }
      cluster.sync();                                     // no rank leaves while read
    }
  }

  // -- epilogue: scale, bias, four consecutive channels per thread, float4 --
  const bool even = (t & 1) == 0;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = y0 + WR * wm + mt / (TW / 16);
    const int xx = x0 + (mt % (TW / 16)) * 16 + g + (even ? 0 : 8);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      if (SPLIT && (mt * NTW + nt) % ks != rank) continue;
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

template <class T, int V4, class WT, bool SPLIT>
int launch_tile(const rt::ConvArgs& a, int ks, cudaStream_t stream) {
  constexpr int SMEM_BYTES = Stage<WT, T::BN>::SMEM_BYTES;
  auto kernel = tc_conv_kernel<T, V4, WT, SPLIT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  const dim3 grid(tiles * ks, (a.Cout + T::BN - 1) / T::BN, a.N);
  if (ks == 1) {
    kernel<<<grid, T::NT, SMEM_BYTES, stream>>>(a, 1);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, ks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class WT, int BN>
bool vec4(const rt::ConvArgs& a) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w);
  return a.Cin % 4 == 0 && a.Cout % Stage<WT, BN>::VEC == 0 && p % 16 == 0;
}

// The wide tile.  layout kRule: 16 warps per block where the 128-wide grid
// fits the SMs once over (one 64 x 64 latent's 3x3 convs: 128 blocks), else
// 8 warps and two blocks per SM; kWide8, kWide16 and kHalf8 as named.
// a.N <= 65535, a.Cout > 0.
template <class WT>
int launch_wide(const rt::ConvArgs& a, int layout, cudaStream_t stream) {
  if (rt::Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  if (layout == kRule) {
    const int sms = tc::sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    const long blocks = (long)a.N * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW) *
                        ((a.Cout + Wide::BN - 1) / Wide::BN);
    layout = blocks <= sms ? kWide16 : kWide8;
  }
  const bool v4 = vec4<WT, Wide::BN>(a);
  switch (layout) {
    case kWide8:
      return v4 ? launch_tile<Wide, 1, WT, false>(a, 1, stream)
                : launch_tile<Wide, 0, WT, false>(a, 1, stream);
    case kWide16:
      return v4 ? launch_tile<WideOnce, 1, WT, false>(a, 1, stream)
                : launch_tile<WideOnce, 0, WT, false>(a, 1, stream);
    case kHalf8:
      if (!v4) return (int)cudaErrorInvalidValue;
      return launch_tile<Half, 1, WT, false>(a, 1, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The 32-wide tile (Cout <= 32), no prologue, 3x3 taps, its K split over a
// cluster of ks blocks (1, 2, 4 or 8, at most one per chunk).
template <class WT>
int launch_narrow(const rt::ConvArgs& a, int ks, cudaStream_t stream) {
  if (rt::Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  if (a.Cout > Narrow::BN || (ks & (ks - 1)) != 0 || ks < 1 || ks > MAX_SPLIT ||
      ks > (a.Cin + BK - 1) / BK)
    return (int)cudaErrorInvalidValue;
  return vec4<WT, Narrow::BN>(a) ? launch_tile<Narrow, 1, WT, true>(a, ks, stream)
                                  : launch_tile<Narrow, 0, WT, true>(a, ks, stream);
}

}  // namespace tcc
