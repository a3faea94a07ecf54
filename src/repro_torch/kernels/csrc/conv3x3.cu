// 3x3 SAME convolution.
//
// Replaces src/repro/kernels/conv3x3.py::conv3x3 (_conv_kernel): no
// prologue, fp32 out.  (The decode's fused uint8 output epilogue has its
// own kernel, output_epilogue.cu.)
//
// conv3x3 with Cout > 4: the 3xTF32 tensor-core tile of tc_conv_tile.cuh
// with no prologue and 3x3 taps.  Its callers (ms per call by
// chip_smoke.py on an H100 80GB HBM3 at 700 W, F.conv2d's in brackets):
//   the decoder's conv_in, 16 -> 512 on the latent, one 16-channel chunk:
//     0.048-0.068 (0.071-0.072);
//   the encoder's conv_in, 3 -> 128 at full resolution: Cin = 3 is read
//     one channel at a time and zero-padded to the chunk, the 8-deep half
//     past Cin skipped; its bound is its 134 MB of output (each thread
//     stores float4s), but it runs at a fifth of that, held like every
//     shape of the tile by the rate of its products: 0.211-0.216
//     (0.299-0.307);
//   the encoder's conv_out, 512 -> 32 on the latent: the 32-wide Cout tile,
//     whose 32 blocks per image would leave 100 of 132 SMs idle, so its K
//     is split over a cluster of ks blocks (ks from the wrapper, 8 here),
//     merged in rank order through distributed shared memory: 0.088-0.128
//     (0.140-0.159), where the 128-wide CUDA-core tile took 0.878.
// Bound on the H100: operations for the latent-sized convs, bytes for the
// full-resolution conv_in.
//
// Cout <= 4 (the float decode's conv_out, 128 -> 3) stays on the narrow
// CUDA-core tile of conv_tile.cuh in full fp32: a matrix tile would be
// 97 % idle, and the shape moves more bytes than it computes (conv_out:
// 0.345-0.362 ms, F.conv2d 0.803-0.835).

#include "tc_conv_tile.cuh"

namespace {

template <class WT>
int launch_tc(const rt::ConvArgs& a, int ksplit, int layout, cudaStream_t stream) {
  if (a.Cout <= tcc::Narrow::BN) {
    if (layout != tcc::kRule) return (int)cudaErrorInvalidValue;   // one layout
    return tcc::launch_narrow<WT>(a, ksplit, stream);
  }
  if (ksplit != 1) return (int)cudaErrorInvalidValue;
  return tcc::launch_wide<WT>(a, layout, stream);
}

}  // namespace

// x [N, H, W, Cin], w [3, 3, Cin, Cout] in its storage type wtype (0 fp32,
// 1 bf16, 2 int8 with wscale [Cout]), b [Cout], out [N, H, W, Cout] fp32,
// all contiguous; K split over ksplit blocks where 4 < Cout <= 32 (else 1);
// layout a tcc::Layout code for Cout > 32 (else 0: those routes have one).
extern "C" int conv3x3_launch(const float* x, const void* w, const float* wscale,
                              const float* b, float* out, int N, int H, int W,
                              int Cin, int Cout, int ksplit, int wtype, int layout,
                              cudaStream_t stream) {
  rt::ConvArgs a{x, nullptr, nullptr, nullptr, w, wscale, b, out, N, H, W, Cin, Cout, 1};
  if (Cout <= 4) {
    if (ksplit != 1 || layout != tcc::kRule) return (int)cudaErrorInvalidValue;
    return rt::launch_narrow_conv(a, wtype, stream);
  }
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  switch (wtype) {
    case rt::kF32: return launch_tc<float>(a, ksplit, layout, stream);
    case rt::kBF16: return launch_tc<rt::bf16w>(a, ksplit, layout, stream);
    case rt::kI8: return launch_tc<int8_t>(a, ksplit, layout, stream);
  }
  return (int)cudaErrorInvalidValue;
}
