// Fused GroupNorm + SiLU + 3x3 SAME convolution on the H100's tensor cores:
// an implicit GEMM in 3xTF32 on warpgroup products (wgmma m64n128k8 TF32).
//
// Replaces src/repro/kernels/gn_silu_conv.py::gn_silu_conv3x3
// (_fused_kernel), the decoder's res-block hot path.  The per-(n, group)
// statistics come first from gn_stats.cu.
//
// Bound on the H100: operations.  At the decoder's widths (Cin, Cout of
// 128-512) a 3x3 conv does 9 * Cin MACs per output element against a few
// bytes.  Design: the warpgroup tile of wg_conv_tile.cuh with the
// GroupNorm + affine + SiLU prologue (SiLU with the special-function
// unit's exp and reciprocal) and 3x3 taps: two producer warpgroups stage
// the weights, split and laid out K-major, and the normalised halo, split
// into its hi and lo TF32 planes, in shared memory; two consumer
// warpgroups run the products.  The normalised activation never reaches
// device memory.  Determinism: one block per (image, two rows of 64
// pixels, 128-channel Cout tile), a fixed K order, no split-K: each
// image's result is independent of the batch.  Weights in their storage
// type (the TPU kernel's quantized operand forms, gn_silu_conv.py:77,
// 132-138): fp32, bf16, or int8 codes with a per-Cout scale, bf16 and int8
// on two TF32 products per product.  At the SD3.5 VAE's 128 x 128 x 512 ->
// 512 it takes 0.853 ms against a 0.469 ms 3xTF32 bound, where the
// mma.sync tile it replaces took 1.588 (chip_compare.py on an H100 80GB
// HBM3 at 700 W; every decode shape in PERF.md, section 6).
//
// Cout <= 4 (no main-path caller) keeps the narrow CUDA-core tile of
// conv_tile.cuh: a matrix tile 128 channels wide would be 97 % idle.

#include "wg_conv_tile.cuh"

namespace {

template <class WT>
int launch_typed(const rt::ConvArgs& a, int layout, cudaStream_t stream) {
  if (a.Cout <= 4) {
    if (layout != wgc::kRule) return (int)cudaErrorInvalidValue;   // one layout
    return rt::launch_conv_tile<rt::NarrowCfg, 1, WT>(a, stream);
  }
  return wgc::launch<wgc::kGnSilu, 9, WT>(a, layout, stream);
}

}  // namespace

// x [N, H, W, Cin], stats [N, G, 2] (mean, rstd), gamma/beta [Cin], w [3, 3,
// Cin, Cout] in its storage type wtype (0 fp32, 1 bf16, 2 int8 with wscale
// [Cout]), b [Cout], out [N, H, W, Cout]; the rest fp32; all contiguous;
// layout a wgc::Layout code for Cout > 4 (else 0).
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

// One wgmma TF32 product through the tile's operand layouts (a check on
// the card): a [64, 8], b [8, 128], d [64, 128], fp32, contiguous.
extern "C" int wgmma_tf32_probe_launch(const float* a, const float* b, float* d,
                                       cudaStream_t stream) {
  wgc::wgmma_tf32_probe_kernel<<<1, 128, 0, stream>>>(a, b, d);
  return (int)cudaGetLastError();
}
