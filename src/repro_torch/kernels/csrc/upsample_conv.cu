// Nearest-2x upsample fused with a 3x3 SAME convolution.
//
// Replaces src/repro/kernels/upsample_conv.py::upsample_conv3x3
// (_upsample_conv_kernel, with its weights collapsed by phase_weights).
//
// Bound on the H100: operations (fp32 FMAs; the decoder's upsamplers run
// at 512 and 256 channels).  Design: the phase decomposition of the TPU
// kernel.  Output pixel (2i+pi, 2j+pj) of conv3x3(upsample2x(x)) reads only
// a 2x2 neighbourhood of x, so with the taps collapsed per phase (done once
// per call in the Python wrapper, the torch phase_weights) each phase is a
// 2x2 convolution of the pre-upsample tensor: 16 taps over H*W pixels
// instead of 9 over 4*H*W, 2.25x fewer FMAs, and the 4x upsampled tensor
// is never written to device memory.  The tile is conv_tile.cuh's with
// UPS = 1: blockIdx.y carries the phase, the block reads the pre-upsample
// halo and writes its phase's pixels of the interleaved [2H, 2W] output.
// The zero halo at the image edge is exactly the SAME padding of the
// upsampled image (the input is pre-activation), so no ring masking.
//
// Weights (the TPU kernel's quantized operand forms, upsample_conv.py:
// 66-97, 126-144): fp32; bf16 collapsed in bf16 (each add rounded, as the
// reference collapses them); int8 codes collapsed in int16, exact since a
// collapsed tap sums at most four codes, with the per-Cout scale applied
// to the fp32 sum before the bias.  Each is widened to fp32 as it is
// staged in shared memory.

#include "conv_tile.cuh"

// wc in its storage type wtype (0 fp32, 1 bf16, 3 int16 with wscale [Cout])
extern "C" int upsample_conv3x3_launch(const float* x, const void* wc,
                                       const float* wscale, const float* b,
                                       float* out, int N, int H, int W,
                                       int Cin, int Cout, int wtype,
                                       cudaStream_t stream) {
  rt::ConvArgs a{x, nullptr, nullptr, nullptr, wc, wscale, b, out,
                 N, H, W, Cin, Cout, 1};
  return rt::launch_conv_typed<0, 0, 1, 1>(a, wtype, stream);
}
