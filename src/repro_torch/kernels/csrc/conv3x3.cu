// 3x3 SAME convolution with an optional GroupNorm + SiLU prologue and an
// fp32 or uint8 epilogue, on the CUDA cores: one kernel template for two TPU
// kernels.
//
// Replaces, from src/repro/kernels/:
//   conv3x3.py::conv3x3 (_conv_kernel)                     PRO none, EPI f32
//   output_epilogue.py::output_epilogue (_epilogue_kernel)  PRO gn+silu, EPI u8
// The GroupNorm statistics pass of the fused kernel runs first, in
// gn_stats.cu.  gn_silu_conv.py::gn_silu_conv3x3 has a tensor-core kernel of
// its own, gn_silu_conv.cu.
//
// Bound on the H100: operations.  At the decoder's widths (Cin, Cout of
// 128-512) a 3x3 conv does 9*Cin FMAs per output element against a few
// bytes, far above the card's fp32 ridge; only conv_out (Cout = 3, the
// uint8 epilogue) moves more bytes than it computes.  Design: the tile in
// conv_tile.cuh, an implicit GEMM on the CUDA cores in full fp32 (no TF32,
// so the decode keeps the fp32 contract of the JAX package) with an 8x8
// register tile per thread, the input halo and the weights of every tap
// staged once per 8-channel chunk in shared memory, and each halo row
// reused by the three taps of a filter row.  The normalised activation
// exists only in shared memory; the uint8 epilogue writes a quarter of the
// fp32 bytes.  The 3xTF32 tile of gn_silu_conv.cu is the way to the tensor
// cores for these two as well.

#include "conv_tile.cuh"

// w in its storage type wtype (0 fp32, 1 bf16, 2 int8 with wscale [Cout])
extern "C" int conv3x3_launch(const float* x, const float* stats,
                              const float* gamma, const float* beta,
                              const void* w, const float* wscale,
                              const float* b, void* out, int N, int H, int W,
                              int Cin, int Cout, int G, int pro, int epi,
                              int wtype, cudaStream_t stream) {
  rt::ConvArgs a{x, stats, gamma, beta, w, wscale, b, out, N, H, W, Cin, Cout, G};
  if (pro == 0 && epi == 0) return rt::launch_conv_typed<0, 0, 0>(a, wtype, stream);
  if (pro == 1 && epi == 1) return rt::launch_conv_typed<1, 1, 0>(a, wtype, stream);
  return (int)cudaErrorInvalidValue;
}
