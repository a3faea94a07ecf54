// The direct 3x3 convolution tile on the CUDA cores, for the shapes a
// matrix tile would leave almost idle: conv3x3.cu's Cout <= 4 (the float
// decode's conv_out, 128 -> 3) and gn_silu_conv.cu's Cout <= 4.  NHWC fp32
// activations, HWIO weights in their storage type, fp32 accumulation and
// output.  Every conv with Cout > 4 runs on the tensor-core tile of
// tc_conv_tile.cuh, and the decode's uint8 epilogue on output_epilogue.cu;
// both take their argument block and weight types from here.
//
// Weights (WT): fp32, bf16 or int8 codes (int16, the upsampler's
// collapsed int8 taps, only on the tensor-core tile).  Each is converted
// to fp32 as the chunk's weights are staged in shared memory; every one of
// these types is exact in fp32, so the products and the sum order are
// those of an fp32 weight of the same value, and the dequantized weight
// never exists in device memory.  An integer weight's per-output-channel scale multiplies the
// fp32 sum before the bias (the order of the TPU kernels,
// conv3x3.py:102-108).
//
// One block computes an output tile of TH x TW pixels of ONE image by BN
// output channels.  For every chunk of BK input channels it stages the
// tile's input halo, (TH+2) x (TW+2) x BK, in shared memory together with
// the chunk's weights for every tap, then each thread accumulates a
// TPM-pixel x TPN-channel register tile.  A halo element outside the image
// is stored as zero after the prologue, which is the SAME padding ring of
// the TPU kernels (gn_silu_conv.py:59-65: silu(gn(0)) != 0, so the ring
// must be zeroed after the activation); it falls out of the bounds test of
// the halo load.  The TPU kernels' materialize_bands (conv3x3.py:42-51)
// existed only because BlockSpecs cannot overlap and has no counterpart.
//
// Prologue (PRO): none, or GroupNorm + affine + SiLU from per-(n, group)
// statistics, applied once per halo element as it is loaded.
//
// Every output element is summed in one fixed order (channel chunk, tap
// row, channel, tap column) by one thread, with no split over images or
// blocks, so a decode of N images gives each image bit-identical results
// to a decode of that image alone.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// a bf16 weight as stored (its 16 bits; fp32 is the same bits << 16)
struct bf16w {
  uint16_t bits;
};

// the weight storage types in the C interfaces (build.py's WEIGHT_CODES)
enum WeightType { kF32 = 0, kBF16 = 1, kI8 = 2, kI16 = 3 };

// integer weights carry a per-output-channel dequant scale
template <class WT> struct Scaled { static constexpr bool value = false; };
template <> struct Scaled<int8_t> { static constexpr bool value = true; };
template <> struct Scaled<int16_t> { static constexpr bool value = true; };

// a stored weight in fp32 (exact for every storage type)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16w v) { return __uint_as_float((uint32_t)v.bits << 16); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f32(int16_t v) { return (float)v; }

// ... loaded through the read-only cache
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16w* p) {
  return __uint_as_float((uint32_t)__ldg(&p->bits) << 16);
}
__device__ __forceinline__ float ldg_f32(const int8_t* p) { return (float)__ldg(p); }

template <int TH_, int TW_, int BN_, int TPM_, int TPN_>
struct ConvCfg {
  static constexpr int TH = TH_, TW = TW_, BN = BN_, TPM = TPM_, TPN = TPN_;
  static constexpr int BK = 8;
  static constexpr int BM = TH * TW;
  static constexpr int NTN = BN / TPN;     // threads along output channels
  static constexpr int NTM = BM / TPM;     // threads along pixels
  static constexpr int THREADS = NTN * NTM;
  static constexpr int NG = TPN / 4;       // float4 channel groups a thread owns
  static_assert(TW % TPM == 0, "a thread's pixels stay in one row");
  static_assert(TPN % 4 == 0, "channel groups are float4");
};

// Cout <= 4 (the decoder's conv_out): 512 pixels x 4 channels, 4x4 per
// thread; too narrow for a matrix unit, so CUDA-core FMAs.
using NarrowCfg = ConvCfg<16, 32, 4, 4, 4>;

struct ConvArgs {
  const float* x;      // [N, H, W, Cin]
  const float* stats;  // [N, G, 2] (mean, rstd) for PRO == 1
  const float* gamma;  // [Cin] for PRO == 1
  const float* beta;   // [Cin] for PRO == 1
  const void* w;       // [3, 3, Cin, Cout], or the upsampler's [2, 2, 2, 2, Cin, Cout]
  const float* wscale; // [Cout] dequant scale of an integer weight, else null
  const float* bias;   // [Cout]
  void* out;           // [N, H, W, Cout] f32, or the upsampler's [N, 2H, 2W, Cout]
  int N, H, W, Cin, Cout, G;
};

template <class Cfg, int PRO, class WT>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::THREADS >= 256 ? 2 : 4)
conv_tile_kernel(ConvArgs a) {
  constexpr int TH = Cfg::TH, TW = Cfg::TW, BN = Cfg::BN, BK = Cfg::BK;
  constexpr int TPM = Cfg::TPM, TPN = Cfg::TPN, NG = Cfg::NG;
  constexpr int THREADS = Cfg::THREADS;
  constexpr int RT = 3, CT = 3, NT = 9;   // tap rows, columns, taps
  constexpr int HH = TH + 2, HWD = TW + 2;
  constexpr int AV = TPM + CT - 1;         // halo columns a thread reads

  __shared__ float As[BK][HH][HWD];
  __shared__ __align__(16) float Ws[NT][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % Cfg::NTN, ty = tid / Cfg::NTN;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int img = blockIdx.z;
  const int p0 = ty * TPM;
  const int r = p0 / TW, c0 = p0 % TW;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const float* __restrict__ x = a.x + (size_t)img * H * W * Cin;
  const WT* __restrict__ w = static_cast<const WT*>(a.w);
  const int cpg = PRO ? Cin / a.G : 1;

  float acc[TPM][TPN];
#pragma unroll
  for (int i = 0; i < TPM; ++i)
#pragma unroll
    for (int j = 0; j < TPN; ++j) acc[i][j] = 0.f;

  for (int ck = 0; ck < Cin; ck += BK) {
    // -- input halo of this channel chunk (prologue applied once) ---------
    for (int e = tid; e < BK * HH * HWD; e += THREADS) {
      const int k = e % BK, pix = e / BK;
      const int hr = pix / HWD, hc = pix % HWD;
      const int gy = y0 + hr - 1, gx = x0 + hc - 1, c = ck + k;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v = __ldg(x + ((size_t)gy * W + gx) * Cin + c);
        if (PRO) {
          const int gi = img * a.G + c / cpg;
          const float t = (v - __ldg(a.stats + 2 * gi)) *
                              __ldg(a.stats + 2 * gi + 1) * __ldg(a.gamma + c) +
                          __ldg(a.beta + c);
          v = t / (1.f + expf(-t));
        }
      }
      As[k][hr][hc] = v;
    }
    // -- this chunk's weights for every tap --------------------------------
    for (int e = tid; e < NT * BK * BN; e += THREADS) {
      const int nn = e % BN, kk = (e / BN) % BK, t = e / (BN * BK);
      const int c = ck + kk, co = n0 + nn;
      Ws[t][kk][nn] = (c < Cin && co < Cout)
                          ? ldg_f32(w + ((size_t)t * Cin + c) * Cout + co)
                          : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int ry = 0; ry < RT; ++ry) {
      const int hr = r + ry;
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[AV];
#pragma unroll
        for (int i = 0; i < AV; ++i) av[i] = As[k][hr][c0 + i];
#pragma unroll
        for (int cx = 0; cx < CT; ++cx) {
          float bv[TPN];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const float4 q = *reinterpret_cast<const float4*>(
                &Ws[ry * CT + cx][k][g * (BN / NG) + tx * 4]);
            bv[4 * g + 0] = q.x;
            bv[4 * g + 1] = q.y;
            bv[4 * g + 2] = q.z;
            bv[4 * g + 3] = q.w;
          }
#pragma unroll
          for (int i = 0; i < TPM; ++i)
#pragma unroll
            for (int j = 0; j < TPN; ++j)
              acc[i][j] = fmaf(av[i + cx], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // -- epilogue -------------------------------------------------------------
  const int y = y0 + r;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < TPM; ++i) {
    const int xx = x0 + c0 + i;
    if (xx >= W) continue;
    const size_t opix = ((size_t)img * H + y) * W + xx;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int cb = n0 + g * (BN / NG) + tx * 4;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool in = cb + jj < Cout;
        float t = acc[i][4 * g + jj];
        if (Scaled<WT>::value) t = __fmul_rn(t, in ? __ldg(a.wscale + cb + jj) : 0.f);
        v[jj] = t + (in ? __ldg(a.bias + cb + jj) : 0.f);
      }
      float* o = static_cast<float*>(a.out) + opix * Cout + cb;
      if ((Cout & 3) == 0 && cb + 3 < Cout) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (cb + jj < Cout) o[jj] = v[jj];
      }
    }
  }
}

template <class Cfg, int PRO, class WT>
int launch_conv_tile(const ConvArgs& a, cudaStream_t stream) {
  if (Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  const int tiles = ((a.H + Cfg::TH - 1) / Cfg::TH) *
                    ((a.W + Cfg::TW - 1) / Cfg::TW);
  const int ntiles = (a.Cout + Cfg::BN - 1) / Cfg::BN;
  const dim3 grid(tiles, ntiles, a.N);
  conv_tile_kernel<Cfg, PRO, WT><<<grid, Cfg::THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// conv3x3 with Cout <= 4, no prologue, for the storage type code wtype
// (fp32, bf16 or int8)
inline int launch_narrow_conv(const ConvArgs& a, int wtype, cudaStream_t stream) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.Cin <= 0 || a.Cout <= 0 ||
      a.Cout > NarrowCfg::BN || a.N > 65535)
    return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case kF32: return launch_conv_tile<NarrowCfg, 0, float>(a, stream);
    case kBF16: return launch_conv_tile<NarrowCfg, 0, bf16w>(a, stream);
    case kI8: return launch_conv_tile<NarrowCfg, 0, int8_t>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
