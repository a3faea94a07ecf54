// The decode's fused output epilogue: GroupNorm + affine + SiLU, the 3x3
// conv_out (Cin -> 3), clamp to [-1, 1] and the uint8 display mapping, so
// the decode's last write is the displayable image itself.
//
// Replaces src/repro/kernels/output_epilogue.py::output_epilogue
// (_epilogue_kernel).  Its GroupNorm statistics come first from
// gn_stats.cu (the wrapper launches it).
//
// Bound on the H100: bytes.  At the decoder's 512x512x128 -> 3 one image
// reads 134 MB (0.040 ms at 3.35 TB/s) and does 2.15 GFLOP, products and
// prologue (0.032 ms at the CUDA cores' 67 TFLOP/s), so the CUDA cores are the
// right engine: a tensor-core tile would leave 5/8 of an n = 8 fragment
// idle for three output channels, and fp32 accuracy would cost three TF32
// products each.  The statistics need their own read of x (134 MB does
// not stay in the 50 MB L2), so the two passes together cannot go below
// 0.080 ms.
//
// Design.  A block computes a TH x 32 pixel tile of one image for three
// output channels (grid: tiles, Cout / 3 rounded up, images): TH = 16, 512
// threads, one block per SM; or, by the launch's tile_h (the autotuner's
// knob, kernels/autotune.py), TH = 8, 256 threads, two blocks per SM,
// compiled for the vectorised path only.  A thread's outputs and their sum
// order below do not depend on TH, so both heights give the same bits
// (at 512 x 512 x 128 they ran within 3 % of each other at buckets 1 and
// 8, the faster one changing between two sweeps; chip_smoke.py phase
// autotune, H100 80GB HBM3, 700 W).  TH
// = 32 is not compiled: its three-stage ring alone takes 228,480 of a
// block's 232,448 bytes of shared memory (32 channels of filter left), and
// 1024 threads leave 64 registers a thread.
//  - Weights: the block's whole filter, 9 x Cin x 3 fp32 (13.8 KB at Cin =
//    128), is staged in shared memory once, converted from its storage
//    type (bf16 and int8 are exact in fp32), as float4s over four channels
//    of one (tap, output), each a broadcast read; an int8 weight's per-Cout
//    scale multiplies the fp32 sum before the bias.  A Cin whose filter
//    exceeds shared memory (above about 700 channels) is staged in
//    segments.
//  - Halo: the 18 x 34 input halo comes in chunks of 16 channels (64
//    contiguous bytes per pixel) by 16-byte cp.async (4-byte where C % 4 or
//    x's alignment forbids) into a ring of three stages, zero-filled
//    outside the image.  Each pixel's four 16-byte units are XOR-swizzled
//    by pixel and a halo row is padded to 35 pixels (odd), so the copies,
//    the prologue and the product loop meet no bank conflicts.
//  - Pipeline, one barrier per chunk: between two barriers every thread
//    activates chunk c + 1 (landed) and sums chunk c (activated before the
//    barrier) while chunk c + 2 is in flight.
//  - Prologue: GN + affine + SiLU once per halo element, in place; pixels
//    outside the image stay zero (the SAME padding ring, applied after
//    the activation as output_epilogue.py:57-63 does).
//  - Products: each thread sums 4 pixels of one row x the 3 output
//    channels, with no padded fourth lane; a row of 6 activations, read as
//    float4s over 4 channels, feeds its three tap columns.  The four
//    16-byte units of a chunk go to four quarters of the block, whose sums
//    are added in a fixed order at the end.
//  - Store: bias, clamp, rint((y + 1) * 127.5) (half to even, as
//    jnp.round), and each thread's 4 x 3 bytes as three 32-bit stores where
//    W % 4 == 0 and Cout == 3.
// Every output is summed in one fixed order (chunk, tap row, tap column,
// channel within each quarter; then quarters 0, 1, 2, 3) by fixed threads,
// with no split over images, so an image decoded in a batch gives the bits
// it gives alone.
//
// 0.1955 ms device time a 512x512 call, 0.050 of it the statistics, and
// 0.26-0.31 ms between CUDA events, which also count the host issuing
// the three launches (chip_compare.py on an H100 80GB HBM3 at 700 W);
// the goal was 0.16.  The exact SiLU below costs 0.025 ms of it over an
// SFU tanh form, which flipped 4.6 times as many bytes by 1 LSB against
// the plain version (5.2e-5 of them, against 1.1e-5).  What holds it
// (scratch variants on the card, not kept): the copies, the
// products and the prologue, each timed alone, take about as long as one
// another and overlap only in part; the products run well under the FMA
// peak.  Two barriers per chunk on two blocks per SM, four stages, a
// persistent grid, 8-pixel runs and 16 x 16 tiles were each as fast or
// slower.

#include "conv_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int TW = 32, HWD = TW + 2;     // output tile width, halo width
constexpr int HROW = HWD + 1;             // a halo row in shared memory (odd)
constexpr int BK = 16, UNITS = BK / 4;    // channels per chunk, float4 units per pixel
constexpr int TPM = 4, NC = 3;            // pixels and output channels per thread
constexpr int KQ = UNITS;                 // quarters of a chunk: one unit each
constexpr int STAGES = 3;                 // computed, activated, in flight
constexpr int TAPS = 9;
constexpr int MAX_SMEM = 232448;          // a block's shared memory on the H100
constexpr int W_BYTES = TAPS * NC * 4;    // a channel's staged weights

// the geometry of a TH x TW output tile
template <int TH_>
struct Geo {
  static constexpr int TH = TH_;
  static constexpr int HH = TH + 2;                      // halo rows
  static constexpr int PT = TH * TW / TPM;               // threads of one quarter
  static constexpr int THREADS = KQ * PT;                // 512 at TH = 16
  static constexpr int STAGE = HH * HROW * UNITS;        // float4 per stage
  static constexpr int HUNITS = HH * HWD * UNITS;        // units a chunk copies
  static constexpr int PER_THREAD = (HUNITS + THREADS - 1) / THREADS;   // ... per thread
  static constexpr int RING_BYTES = STAGES * STAGE * 16;
  static_assert(TH % 4 == 0 && PT % 32 == 0, "four rows a warp");
};
// The weight segment: channels of one weight staging, a function of Cin
// alone (sized beside the taller tile's ring, so every height stages the
// same segments).
inline int weight_segment(int Cin) {
  const int cpad = (Cin + BK - 1) / BK * BK;
  const int wcap = (MAX_SMEM - Geo<16>::RING_BYTES) / W_BYTES / BK * BK;
  return cpad < wcap ? cpad : wcap;
}

struct Args {
  const float* x;       // [N, H, W, Cin]
  const float* stats;   // [N, G, 2] (mean, rstd)
  const float* gamma;   // [Cin]
  const float* beta;    // [Cin]
  const void* w;        // [3, 3, Cin, Cout] in its storage type
  const float* wscale;  // [Cout] for an int8 weight, else null
  const float* bias;    // [Cout]
  uint8_t* out;         // [N, H, W, Cout]
  int N, H, W, Cin, Cout, G;
  int wseg;             // channels of one weight staging (a multiple of BK)
};

// float4 index of unit u of halo pixel slot p: the XOR spreads the four
// 4-pixel runs of a row in a phase of 8 lanes over the four units
__device__ __forceinline__ int phys(int p, int u) { return p * UNITS + (u ^ ((p >> 2) & 3)); }

// silu(u) = u / (1 + exp(-u)), as the fused conv's prologue computes it
// (tc_conv_tile.cuh): a few ulp of u's sigmoid at every u, where the
// special-function unit's tanh (silu = h + h * tanh(h), h = u / 2) errs
// by 2^-11 of tanh, which at u = -6 is a tenth of the result.
__device__ __forceinline__ float act(float v, float2 st, float gamma, float beta) {
  const float u = fmaf((v - st.x) * st.y, gamma, beta);
  return __fdividef(u, 1.f + __expf(-u));
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)rintf((fminf(fmaxf(v, -1.f), 1.f) + 1.f) * 127.5f);
}

template <int TH_, bool V4, class WT>
__global__ void __launch_bounds__(Geo<TH_>::THREADS, 512 / Geo<TH_>::THREADS)
epilogue_kernel(Args a) {
  using G = Geo<TH_>;
  constexpr int TH = G::TH, PT = G::PT, THREADS = G::THREADS, STAGE = G::STAGE;
  constexpr int HUNITS = G::HUNITS, PER_THREAD = G::PER_THREAD;
  extern __shared__ __align__(16) float4 smem[];
  float4* const Ws = smem + STAGES * STAGE;   // [wseg / 4][TAPS][NC] channel quads
  auto ring = [&](int ch) { return smem + (ch % STAGES) * STAGE; };

  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH, x0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * NC, img = blockIdx.z;
  const float* __restrict__ x = a.x + (size_t)img * H * W * Cin;
  const float2* __restrict__ st = reinterpret_cast<const float2*>(a.stats) + img * a.G;
  const WT* __restrict__ w = static_cast<const WT*>(a.w);
  const int cpg = Cin / a.G;
  const int nch = (Cin + BK - 1) / BK;
  const int u_own = tid % UNITS;   // the unit this thread copies and activates

  // this thread's halo units, the same in every chunk: unit k is e = tid +
  // k * THREADS of the chunk's HUNITS; its slot in a stage (-1: none) and
  // its pixel in the image (-1: outside, a zero of the padding ring)
  int slot[PER_THREAD], pix[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = tid + k * THREADS, pi = e / UNITS;
    const int gy = y0 + pi / HWD - 1, gx = x0 + pi % HWD - 1;
    slot[k] = e < HUNITS ? phys((pi / HWD) * HROW + pi % HWD, u_own) : -1;
    pix[k] = e < HUNITS && gy >= 0 && gy < H && gx >= 0 && gx < W ? gy * W + gx : -1;
  }
  // chunk ch's raw halo into buf (zeros outside the image and past Cin)
  auto load = [&](int ch, float4* buf) {
    const int c = ch * BK + 4 * u_own;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (slot[k] < 0) continue;
      const float* src = x + (size_t)(pix[k] < 0 ? 0 : pix[k]) * Cin + c;
      float* dst = reinterpret_cast<float*>(buf + slot[k]);
      if (V4) {
        const bool ok = pix[k] >= 0 && c < Cin;
        tc::cp_async16(dst, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = pix[k] >= 0 && c + j < Cin;
          tc::cp_async4(dst + j, ok ? src + j : x, ok);
        }
      }
    }
  };
  // GN + affine + SiLU in place on chunk ch's halo, inside the image only;
  // all of this thread's units loaded, then activated, then stored, so
  // their loads and exponentials overlap
  auto activate = [&](int ch, float4* buf) {
    const int c = ch * BK + 4 * u_own;
    float2 sv[4];
    float g[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = c + j < Cin;
      sv[j] = ok ? st[(c + j) / cpg] : make_float2(0.f, 0.f);
      g[j] = ok ? __ldg(a.gamma + c + j) : 0.f;
      b[j] = ok ? __ldg(a.beta + c + j) : 0.f;
    }
    float4 v[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (slot[k] >= 0 && pix[k] >= 0) v[k] = buf[slot[k]];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (slot[k] < 0 || pix[k] < 0) continue;
      float t[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < Cin) t[j] = act(t[j], sv[j], g[j], b[j]);
      buf[slot[k]] = make_float4(t[0], t[1], t[2], t[3]);
    }
  };
  // the weights of channels [cs, cs + wseg), outputs n0..n0+2, as
  // [channel quad][tap][output] float4s over the quad's 4 channels
  auto stage_w = [&](int cs) {
    for (int e = tid; e < a.wseg / 4 * TAPS * NC; e += THREADS) {
      const int co = e % NC, t = (e / NC) % TAPS, c = cs + 4 * (e / (NC * TAPS));
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = c + k < Cin && n0 + co < Cout
                   ? rt::ldg_f32(w + ((size_t)t * Cin + c + k) * Cout + n0 + co) : 0.f;
      Ws[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  // this thread's quarter (its unit of each chunk), row and pixel run: a
  // phase of 8 lanes holds two rows (odd row stride) x four runs (distinct
  // swizzles): no bank conflicts
  const int u = tid / PT, pt = tid % PT, l = tid % 32;
  const int r = 4 * (pt / 32) + ((l >> 2) & 1) + 2 * (l >> 4);
  const int j = (l & 3) + 4 * ((l >> 3) & 1);
  float acc[TPM][NC];
#pragma unroll
  for (int i = 0; i < TPM; ++i)
#pragma unroll
    for (int co = 0; co < NC; ++co) acc[i][co] = 0.f;

  auto compute = [&](const float4* buf, int cl0) {
#pragma unroll
    for (int ry = 0; ry < 3; ++ry) {
      const int prow = (r + ry) * HROW + TPM * j;
      float4 av[TPM + 2];
#pragma unroll
      for (int i = 0; i < TPM + 2; ++i) av[i] = buf[phys(prow + i, u)];
      const float4* wr = Ws + ((cl0 / 4 + u) * TAPS + ry * 3) * NC;
#pragma unroll
      for (int cx = 0; cx < 3; ++cx) {
#pragma unroll
        for (int co = 0; co < NC; ++co) {
          const float4 wv = wr[cx * NC + co];   // channels 4u..4u+3
#pragma unroll
          for (int i = 0; i < TPM; ++i) {
            const float4 xv = av[i + cx];
            float t = acc[i][co];
            t = fmaf(xv.x, wv.x, t);
            t = fmaf(xv.y, wv.y, t);
            t = fmaf(xv.z, wv.z, t);
            acc[i][co] = fmaf(xv.w, wv.w, t);
          }
        }
      }
    }
  };

  // One barrier per chunk.  Between two barriers every thread activates
  // chunk ch + 1 (landed) and sums chunk ch (activated before the barrier)
  // while chunk ch + 2 is in flight, so the activations, products and
  // copies of different warps overlap.
  int cs = 0;   // first channel of the staged weights
  load(0, ring(0));
  tc::cp_async_commit();
  if (nch > 1) load(1, ring(1));
  tc::cp_async_commit();
  stage_w(0);               // while the first two chunks are in flight
  tc::cp_async_wait<1>();   // chunk 0 has landed
  __syncthreads();
  activate(0, ring(0));
  for (int ch = 0; ch < nch; ++ch) {
    tc::cp_async_wait<0>();   // chunk ch + 1 has landed (the only group in flight)
    __syncthreads();          // chunk ch is activated; chunk ch - 1's stage is free
    if (ch + 2 < nch) load(ch + 2, ring(ch + 2));
    tc::cp_async_commit();
    if (ch * BK - cs >= a.wseg) {   // a filter above shared memory: next segment
      cs = ch * BK;
      stage_w(cs);
      __syncthreads();
    }
    if (ch + 1 < nch) activate(ch + 1, ring(ch + 1));
    compute(ring(ch), ch * BK - cs);
  }

  // quarters 1-3 leave their sums in shared memory; quarter 0 adds them
  // in order and stores
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [KQ - 1][TPM * NC][PT]
  if (u > 0) {
#pragma unroll
    for (int i = 0; i < TPM; ++i)
#pragma unroll
      for (int co = 0; co < NC; ++co)
        red[((u - 1) * TPM * NC + i * NC + co) * PT + pt] = acc[i][co];
  }
  __syncthreads();
  const int y = y0 + r, xb = x0 + TPM * j;
  if (u > 0 || y >= H) return;
  uint8_t q[TPM * NC];
#pragma unroll
  for (int co = 0; co < NC; ++co) {
    const bool in = n0 + co < Cout;
    const float sc = rt::Scaled<WT>::value && in ? __ldg(a.wscale + n0 + co) : 0.f;
    const float bi = in ? __ldg(a.bias + n0 + co) : 0.f;
#pragma unroll
    for (int i = 0; i < TPM; ++i) {
      float t = acc[i][co];
#pragma unroll
      for (int q = 0; q < KQ - 1; ++q) t += red[(q * TPM * NC + i * NC + co) * PT + pt];
      if (rt::Scaled<WT>::value) t = __fmul_rn(t, sc);
      q[i * NC + co] = to_u8(t + bi);
    }
  }
  uint8_t* o = a.out + (((size_t)img * H + y) * W + xb) * Cout + n0;
  if (Cout == NC && W % 4 == 0 && xb + TPM <= W) {
    uint32_t* o4 = reinterpret_cast<uint32_t*>(o);   // 12 bytes at a 4-byte boundary
#pragma unroll
    for (int k = 0; k < TPM * NC / 4; ++k)
      o4[k] = (uint32_t)q[4 * k] | (uint32_t)q[4 * k + 1] << 8 |
              (uint32_t)q[4 * k + 2] << 16 | (uint32_t)q[4 * k + 3] << 24;
  } else {
#pragma unroll
    for (int i = 0; i < TPM; ++i)
      if (xb + i < W)
#pragma unroll
        for (int co = 0; co < NC; ++co)
          if (n0 + co < Cout) o[i * Cout + co] = q[i * NC + co];
  }
}

template <int TH_, bool V4, class WT>
int launch(Args a, cudaStream_t stream) {
  using G = Geo<TH_>;
  if (rt::Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  a.wseg = weight_segment(a.Cin);
  const int smem = G::RING_BYTES + a.wseg * W_BYTES;
  auto kernel = epilogue_kernel<TH_, V4, WT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.H + G::TH - 1) / G::TH) * ((a.W + TW - 1) / TW);
  const dim3 grid(tiles, (a.Cout + NC - 1) / NC, a.N);
  kernel<<<grid, G::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// tile_h: 0 or 16, or 8 (the vectorised path only); any other is refused
template <class WT>
int launch_typed(const Args& a, int tile_h, cudaStream_t stream) {
  const bool v4 = a.Cin % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  switch (tile_h) {
    case 0:
    case 16: return v4 ? launch<16, true, WT>(a, stream) : launch<16, false, WT>(a, stream);
    case 8: return v4 ? launch<8, true, WT>(a, stream) : (int)cudaErrorInvalidValue;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [N, H, W, Cin] fp32, stats [N, G, 2] (mean, rstd) from gn_stats_launch,
// gamma/beta [Cin], w [3, 3, Cin, Cout] in its storage type wtype (0 fp32,
// 1 bf16, 2 int8 with wscale [Cout]), b [Cout] fp32, out [N, H, W, Cout]
// uint8; all contiguous; tile_h the tile's height (0: 16).
extern "C" int output_epilogue_launch(const float* x, const float* stats,
                                      const float* gamma, const float* beta,
                                      const void* w, const float* wscale,
                                      const float* b, uint8_t* out, int N,
                                      int H, int W, int Cin, int Cout, int G,
                                      int wtype, int tile_h, cudaStream_t stream) {
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      (Cout + NC - 1) / NC > 65535 || G <= 0 || Cin % G != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{x, stats, gamma, beta, w, wscale, b, out, N, H, W, Cin, Cout, G, 0};
  switch (wtype) {
    case rt::kF32: return launch_typed<float>(a, tile_h, stream);
    case rt::kBF16: return launch_typed<rt::bf16w>(a, tile_h, stream);
    case rt::kI8: return launch_typed<int8_t>(a, tile_h, stream);
  }
  return (int)cudaErrorInvalidValue;
}
