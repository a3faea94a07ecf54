// Fused GroupNorm + SiLU + 3x3 SAME convolution on the H100's tensor cores:
// an implicit GEMM in 3xTF32 on mma.sync.m16n8k8.
//
// Replaces src/repro/kernels/gn_silu_conv.py::gn_silu_conv3x3
// (_fused_kernel), the decoder's res-block hot path.  The per-(n, group)
// statistics come first from gn_stats.cu.
//
// Bound on the H100: operations.  At the decoder's widths (Cin, Cout of
// 128-512) a 3x3 conv does 9 * Cin MACs per output element against a few
// bytes.  Design: the tile of tc_conv_tile.cuh with the GroupNorm + affine
// + SiLU prologue (SiLU with the special-function unit's exp and
// reciprocal), 3x3 taps and the 128-wide Cout tile: the normalised
// activation exists only in shared memory, split into its hi and lo TF32
// planes.  Determinism: one block per (image, pixel tile, Cout tile), a
// fixed K order, no split-K: each image's result is independent of the
// batch.  Weights in their storage type (the TPU kernel's quantized
// operand forms, gn_silu_conv.py:77, 132-138): fp32, bf16, or int8 codes
// with a per-Cout scale, bf16 and int8 on two TF32 products per product.
// At the SD3.5 VAE's shapes it runs at 22-29 % of its 3xTF32 bound, e.g.
// 1.624-1.626 ms for 128 x 128 x 512 -> 512 against 0.469 (F.conv2d after
// the GroupNorm: 1.913-1.965; chip_smoke.py on an H100 80GB HBM3 at
// 700 W).
//
// Cout <= 4 (no main-path caller) keeps the narrow CUDA-core tile of
// conv_tile.cuh: a matrix tile 128 channels wide would be 97 % idle.

#include "tc_conv_tile.cuh"

namespace {

template <class WT>
int launch_typed(const rt::ConvArgs& a, int layout, cudaStream_t stream) {
  if (a.Cout <= 4) {
    if (layout != tcc::kRule) return (int)cudaErrorInvalidValue;   // one layout
    return rt::launch_conv_tile<rt::NarrowCfg, 1, WT>(a, stream);
  }
  return tcc::launch_wide<tcc::kGnSilu, 9, WT>(a, layout, stream);
}

}  // namespace

// x [N, H, W, Cin], stats [N, G, 2] (mean, rstd), gamma/beta [Cin], w [3, 3,
// Cin, Cout] in its storage type wtype (0 fp32, 1 bf16, 2 int8 with wscale
// [Cout]), b [Cout], out [N, H, W, Cout]; the rest fp32; all contiguous;
// layout a tcc::Layout code for Cout > 4 (else 0).
extern "C" int gn_silu_conv3x3_launch(const float* x, const float* stats, const float* gamma,
                                      const float* beta, const void* w, const float* wscale,
                                      const float* b, float* out, int N, int H, int W, int Cin,
                                      int Cout, int G, int wtype, int layout,
                                      cudaStream_t stream) {
  rt::ConvArgs a{x, stats, gamma, beta, w, wscale, b, out, N, H, W, Cin, Cout, G};
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || N > 65535 || G <= 0 ||
      Cin % G != 0)
    return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case rt::kF32: return launch_typed<float>(a, layout, stream);
    case rt::kBF16: return launch_typed<rt::bf16w>(a, layout, stream);
    case rt::kI8: return launch_typed<int8_t>(a, layout, stream);
  }
  return (int)cudaErrorInvalidValue;
}
