// Nearest-2x upsample fused with a 3x3 SAME convolution.
//
// Replaces src/repro/kernels/upsample_conv.py::upsample_conv3x3
// (_upsample_conv_kernel, with its weights collapsed by phase_weights).
//
// Bound on the H100: operations (the decoder's upsamplers run at 512 and
// 256 channels).  Design: the phase decomposition of the TPU kernel.
// Output pixel (2i+pi, 2j+pj) of conv3x3(upsample2x(x)) reads only a 2x2
// neighbourhood of x, so with the taps collapsed per phase (the wrapper's
// storage_phase_weights, or taps collapsed beforehand) each phase is a 2x2
// convolution of the pre-upsample tensor: 16 taps over H*W pixels instead
// of 9 over 4*H*W, 2.25x fewer products, and the 4x upsampled tensor is
// never written to device memory.  The tile is wg_conv_tile.cuh's
// warpgroup tile in 3xTF32 with no prologue and the phase form's taps
// (TAPS = 4): blockIdx.y carries the phase and the Cout tile, the block
// reads the pre-upsample halo at the phase's offsets and writes its
// phase's pixels of the interleaved [2H, 2W] output.  The zero halo at the
// image edge is exactly the SAME padding of the upsampled image (the input
// is pre-activation), so no ring masking.  The decoder collapses its taps
// once, when its serving tree is derived (vae/model.py), and launches from
// them.  At 128 x 128 x 512 it takes 1.556 ms against a 0.833 ms 3xTF32
// bound, where the mma.sync tile it replaces took 2.808 (chip_compare.py
// on an H100 80GB HBM3 at 700 W; every decode shape in PERF.md, section
// 6).
//
// Weights (the TPU kernel's quantized operand forms, upsample_conv.py:
// 66-97, 126-144): fp32; bf16 collapsed in bf16 (each add rounded, as the
// reference collapses them); int8 codes collapsed in int16, exact since a
// collapsed tap sums at most four codes (|tap| <= 508), with the per-Cout
// scale applied to the fp32 sum before the bias.  bf16 and int16 taps are
// exact in TF32: two TF32 products per product, the fp32 path's bits.

#include "wg_conv_tile.cuh"

// x [N, H, W, Cin], wc [2, 2, 2, 2, Cin, Cout] in its storage type wtype
// (0 fp32, 1 bf16, 3 int16 with wscale [Cout]), b [Cout], out [N, 2H, 2W,
// Cout], all contiguous; layout a wgc::Layout code
extern "C" int upsample_conv3x3_launch(const float* x, const void* wc,
                                       const float* wscale, const float* b,
                                       float* out, int N, int H, int W,
                                       int Cin, int Cout, int wtype, int layout,
                                       cudaStream_t stream) {
  rt::ConvArgs a{x, nullptr, nullptr, nullptr, wc, wscale, b, out,
                 N, H, W, Cin, Cout, 1};
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case rt::kF32: return wgc::launch<wgc::kRaw, 4, float>(a, layout, stream);
    case rt::kBF16: return wgc::launch<wgc::kRaw, 4, rt::bf16w>(a, layout, stream);
    case rt::kI16: return wgc::launch<wgc::kRaw, 4, int16_t>(a, layout, stream);
  }
  return (int)cudaErrorInvalidValue;
}
