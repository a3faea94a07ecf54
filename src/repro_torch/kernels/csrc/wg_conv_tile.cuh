// The warpgroup conv tile that gn_silu_conv.cu and upsample_conv.cu run
// on: an implicit GEMM in 3xTF32 on wgmma.mma_async.m64n128k8.f32.tf32,
// NHWC fp32 activations, HWIO weights in their storage type.  It computes
// what the mma.sync wide tile of tc_conv_tile.cuh computes (which conv3x3
// keeps), with the same template choices: PRO (GroupNorm + affine + SiLU
// prologue, or none), TAPS (9, a 3x3 SAME conv; or 4, the upsampler's
// phase form: blockIdx.y also carries the output phase (pi, pj) and the
// taps read the pre-upsample halo at (pi + a, pj + b)) and the weight type.
//
// Why wgmma.  mma.sync issues a warp's 16 x 8 x 8 products one instruction
// at a time with both operands loaded into registers by the warp itself;
// the tile on it ran at 22-30 % of its 3xTF32 bound.  A warpgroup's
// m64n128k8 is one instruction for 64 x 128 x 8 products whose operands
// the tensor core reads from shared memory on its own, and it is the only
// way to the card's full tensor-core rate.
//
// GEMM shape: M = 64 output pixels of one row a consumer warpgroup, N =
// 128 output channels a block, K = taps x Cin walked as (16-channel chunk,
// tap), one step per (chunk, tap).  A block is two producer warpgroups and
// NC = 2 consumer warpgroups, 2 rows x 64 pixels; every consumer computes
// its pixels with the same instructions in the same order, so a batch's
// images are independent of how many share the launch.  (One consumer
// warpgroup a block was 1.3-1.6x slower at every decode shape.)
//
// Operands.  wgmma transposes only 16-bit types, so both 32-bit operands
// are K-major no-swizzle core matrices in shared memory (8 rows of 16
// bytes, 4 channels a row), read through descriptors:
//   A, the halo: per 4-channel group a [pixel][4] plane, pixels 16 bytes
//     apart, so a tap's shifted 64-pixel operand is the plane from its
//     first pixel on (the core matrices along M are 128 bytes apart): no
//     im2col buffer.  (A from registers, loaded from [channel][pixel]
//     planes as the mma.sync tile loads its fragments, was no faster in a
//     first version of this tile and held 16 more registers a consumer
//     thread.)
//   B, the weights: the HWIO weights are N-major (Cout contiguous), so
//     they are restaged on the card: each step's raw [16 x 128] slice comes
//     by cp.async, and the thread that copied a 4 x 4 block of it
//     transposes the block in registers, splits each fp32 weight into its
//     hi and lo TF32 halves and stores both K-major into the step's slot.
//     (Laying the weights out K-major, hi and lo, when the serving tree is
//     derived was the other choice: it doubles the resident fp32 weight
//     bytes and the bytes each block reads, cannot serve bf16 or int8
//     storage without an fp32 copy, and changes the kernels' public weight
//     layout, which the plain versions, the autotuner and every caller
//     share.)
//
// Roles (warp specialisation; mbarriers in place of block barriers):
//   warpgroup 0, weights: keeps RAW - 1 steps of cp.async in flight, waits
//     for a slot's `empty` barrier, writes the slot, fences the writes for
//     the async proxy that wgmma reads through and arrives on its `full`
//     barrier;
//   warpgroup 1, halo: copies each chunk's raw 4 x 66 pixel x 16
//     channel halo by cp.async two chunks ahead (zeros outside the image
//     and past Cin), then, once a split buffer is free, passes it through
//     the prologue, sets it to zero outside the image AFTER it (the SAME
//     padding ring: silu(gn(0)) != 0; for the upsampler exactly the SAME
//     padding of the upsampled image), splits it into hi and lo planes and
//     arrives on the buffer's `full` barrier.  Each halo element passes
//     the prologue once per block;
//   warpgroups 2.., consumers: per chunk, wait for its halo; per step,
//     wait for the slot, issue the step's products and wait only for the
//     step before, then free that one's slot, so the tensor core always
//     has a step queued; at the chunk's end wait for its last step, free
//     its slot and the halo, and add the chain to the sum.
// The weights and the halo have a producer warpgroup each: on one, the
// two took longer a step than the consumers' products.  The producers give
// the consumers their registers (setmaxnreg: 96 a producer thread, 160 a
// consumer thread); the launch checks that the block holds the whole
// register file, without which the consumers' request could wait forever.
// Every step the consumers issue the same products and touch no
// accumulator register in between: a conditional product or such an
// access made ptxas serialise every wgmma of the kernel.  The activation
// selects with a mask, not a branch, which would serialise its four
// values' chains.
//
// Numerics (the rules of the mma.sync tile): fp32 weights in 3xTF32, each
// operand carried as hi = tf32(x) and lo = tf32(x - hi), rounded as
// cvt.rna.tf32.f32 rounds, a product as lo*hi + hi*lo + hi*hi.  Chain
// length: one 16-channel chunk, its TAPS steps of two 8-deep slices, 54
// wgmmas (3x3) or 24 (phase form) summed in a fresh accumulator (scale-d 0
// on the first), then added to the fp32 sum on the CUDA cores with
// round-to-nearest (the tensor core's own accumulation does not round to
// nearest and drifts over long chains: on the card a whole-K chain
// missed 1e-4 at Cin = 520).  Slices past Cin add exact zeros (zero halo,
// zero weights).  Every sum has a fixed place and order, set by (H, W,
// Cin, Cout) alone.
//
// Weights in their storage type: fp32, bf16, int8 codes with a per-Cout
// scale, or int16 (the upsampler's int8 taps collapsed per phase, |tap| <=
// 4 * 127, same scale).  bf16 values and integer codes of at most 11 bits
// are exact in TF32: their slot holds the fp32 value alone and each
// product takes two wgmmas (a_lo b, then a_hi b) where fp32 takes three;
// the dropped a_hi b_lo is exactly zero, so the result is the bit pattern
// the fp32 path gives for the same weight values.  Epilogue: the int8
// scale (one rounded multiply), then the bias; neighbouring lanes swap
// halves of their fragments so each thread stores four consecutive
// channels as a float4.
//
// Shared memory (fp32): three split halo buffers of 16 channels x
// 264 pixels, hi and lo (101,376 bytes), two raw ones (33,792), four split
// weight slots (67,584), three raw weight stages (24,576): 227,456 bytes,
// one block an SM.  Bank conflicts: halo stores and reads are 16 bytes a
// lane on consecutive pixels; a slot's 8-channel groups are 528 bytes
// apart (4 core matrices and 16 bytes), so the weight stores of channels
// 4 l + j by lanes l hit 8 distinct 16-byte bank groups in each quarter
// warp.

#pragma once

#include "conv_tile.cuh"
#include "hopper_mma.cuh"

namespace wgc {

constexpr int TW = 64;                 // output pixels of a consumer: one row
constexpr int BK = 16;                 // input channels a chunk
constexpr int BN = 128;                // output channels a block
constexpr int HWD = TW + 2;            // halo columns
constexpr int STAGES = 4;              // split weight slots
constexpr int RAW = 3;                 // raw weight stages (RAW - 1 in flight)
constexpr int HALO_BUFS = 3;           // split halo buffers (chunks)
constexpr int RAW_HALOS = 2;           // raw halo buffers (chunks in flight)
constexpr int SBO = 4 * 128 + 16;      // bytes between a slot's 8-channel groups
constexpr int BPLANE = BN / 8 * SBO;   // one plane (hi or lo) of a slot
constexpr int PRODUCERS = 128;         // threads of a producer warpgroup
constexpr int NC = 2;                  // consumer warpgroups, a row of 64 pixels each

enum Prologue { kRaw = 0, kGnSilu = 1 };

// The launch's layout codes: the tile has one layout, which the rule's code
// and kRows2 (the tuning cache's name for it) both launch; any other code
// is cudaErrorInvalidValue.
enum Layout { kRule = 0, kRows2 = 1 };

// byte offset of weight (n, k) in a slot plane: K-major no-swizzle core
// matrices, 8 rows (n) of 16 bytes (4 k), 128 bytes apart along K and SBO
// along N
__host__ __device__ constexpr int slot_off(int n, int k) {
  return (n >> 3) * SBO + (k >> 2) * 128 + (n & 7) * 16 + (k & 3) * 4;
}

// the descriptor of a k8 slice (k0 a multiple of 8) of a slot plane
__device__ __forceinline__ uint64_t slice_desc(const unsigned char* plane, int k0) {
  return tc::make_desc(plane + slot_off(0, k0), 128, SBO);
}

template <class WT>
struct Smem {
  static constexpr bool F32 = sizeof(WT) == 4;
  static constexpr int NT = 128 * (NC + 2);
  static constexpr int HPIX = (NC + 2) * HWD;                  // halo pixels
  static constexpr int KG_BYTES = HPIX * 16;                  // 4 channels at every halo pixel
  static constexpr int PLANE_BYTES = BK / 4 * KG_BYTES;       // a chunk's hi or lo plane
  static constexpr int HALO_BYTES = 2 * PLANE_BYTES;          // hi and lo
  static constexpr int SLOT_BYTES = (F32 ? 2 : 1) * BPLANE;
  static constexpr int BAR_BYTES = 128;                       // the mbarriers
  static constexpr int HALO_OFF = BAR_BYTES;
  static constexpr int SLOT_OFF = HALO_OFF + HALO_BUFS * HALO_BYTES;
  static constexpr int RAWH_OFF = SLOT_OFF + STAGES * SLOT_BYTES;   // raw halos
  static constexpr int RAW_OFF = RAWH_OFF + RAW_HALOS * PLANE_BYTES;  // raw weights
  static constexpr int RAW_ELEMS = BK * BN;
  static constexpr int BYTES = RAW_OFF + RAW * RAW_ELEMS * (int)sizeof(WT);
  static_assert((2 * STAGES + 2 * HALO_BUFS) * 8 <= BAR_BYTES, "barriers fit");
  static_assert(SLOT_OFF % 16 == 0 && RAWH_OFF % 16 == 0 && RAW_OFF % 16 == 0,
                "16-byte aligned operands");
  static_assert(BYTES <= 232448, "one block an SM");
};

// the A descriptor of a k8 slice (k0 a multiple of 8) of a halo plane,
// from halo pixel p0 on: K-major core matrices, 8 pixels of 16 bytes (4
// channels), the next 4 channels KG_BYTES on, the next 8 pixels 128
__device__ __forceinline__ uint64_t halo_desc(const unsigned char* plane, int kg_bytes, int k0,
                                              int p0) {
  return tc::make_desc(plane + (k0 / 4) * kg_bytes + p0 * 16, kg_bytes, 128);
}

// four stored weights (consecutive output channels) from shared memory
__device__ __forceinline__ float4 raw4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 raw4(const rt::bf16w* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 raw4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 raw4(const int16_t* p) {
  const short4 s = *reinterpret_cast<const short4*>(p);
  return make_float4((float)s.x, (float)s.y, (float)s.z, (float)s.w);
}

// an async copy of four stored weights (16, 8 or 4 bytes); zeros if !ok
template <class WT>
__device__ __forceinline__ void copy4(WT* dst, const WT* src, bool ok) {
  if constexpr (sizeof(WT) == 4) tc::cp_async16(dst, src, ok);
  else if constexpr (sizeof(WT) == 2) tc::cp_async8(dst, src, ok);
  else tc::cp_async4(dst, src, ok);
}

// V4: Cin % 4 == 0 and 16-byte aligned x (and gamma, beta): the halo is
// copied four channels at a time; Cout % 4 == 0 and the weights aligned to
// four of them: the weights come by cp.async.  Else one value at a time.
template <int PRO, int TAPS, int V4, class WT>
__global__ void __launch_bounds__(128 * (NC + 2), 1)
wg_conv_kernel(rt::ConvArgs a) {
  using SM = Smem<WT>;
  constexpr bool F32 = SM::F32;
  constexpr int HPIX = SM::HPIX, KG_BYTES = SM::KG_BYTES, PLANE_BYTES = SM::PLANE_BYTES;
  static_assert(TAPS == 9 || TAPS == 4, "3x3 taps or the 2x2 phase form");
  extern __shared__ __align__(128) unsigned char sm[];
  uint64_t* const wfull = reinterpret_cast<uint64_t*>(sm);
  uint64_t* const wempty = wfull + STAGES;
  uint64_t* const hfull = wempty + STAGES;
  uint64_t* const hempty = hfull + HALO_BUFS;
  unsigned char* const halo = sm + SM::HALO_OFF;             // [3][hi, lo][BK / 4][HPIX][4]
  unsigned char* const slots = sm + SM::SLOT_OFF;            // [STAGES][hi, lo]
  WT* const raw = reinterpret_cast<WT*>(sm + SM::RAW_OFF);   // [RAW][BK][BN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_w = (a.W + TW - 1) / TW;
  const int y0 = (int)(blockIdx.x / tiles_w) * NC, x0 = (int)(blockIdx.x % tiles_w) * TW;
  const int phase = TAPS == 4 ? (int)(blockIdx.y & 3) : 0;
  const int pi = phase >> 1, pj = phase & 1;
  const int n0 = (TAPS == 4 ? (int)(blockIdx.y >> 2) : (int)blockIdx.y) * BN, img = blockIdx.z;
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int chunks = (Cin + BK - 1) / BK, steps = chunks * TAPS;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      tc::mbar_init(&wfull[i], PRODUCERS);
      tc::mbar_init(&wempty[i], 4 * NC);
    }
    for (int i = 0; i < HALO_BUFS; ++i) {
      tc::mbar_init(&hfull[i], PRODUCERS);
      tc::mbar_init(&hempty[i], 4 * NC);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();

  // registers: the two producer warpgroups give theirs to the consumers
  constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 160;
  static_assert(2 * PRODUCER_REGS + NC * CONSUMER_REGS == 65536 / 128,
                "the reallocation uses the whole register file");

  // -- warpgroup 0, the weights ---------------------------------------------
  if (warp < 4) {
    tc::regs_lower<PRODUCER_REGS>();
    // this thread's block of input channels 4 kb.. and output
    // channels nl.. of each step: raw HWIO rows by cp.async RAW - 1 steps
    // ahead, then split and stored K-major into the step's slot
    const int kb = warp, nl = 4 * lane;
    const bool n_in = n0 + nl < Cout;
    const WT* const wrow = static_cast<const WT*>(a.w) + (size_t)phase * TAPS * Cin * Cout +
                           (size_t)(4 * kb) * Cout + n0 + nl;
    int slot_off_j[4];                       // this thread's four channels in a slot plane
#pragma unroll
    for (int j = 0; j < 4; ++j) slot_off_j[j] = slot_off(nl + j, 4 * kb);
    // the issue cursor: the step RAW - 1 ahead of the one converted
    int ich = 0, itap = 0, ist = 0;
    size_t ioff = 0;                         // (itap * Cin + ich * BK) * Cout
    auto issue = [&]() {
      if (V4 && ich < chunks) {
        WT* dst = raw + ist * SM::RAW_ELEMS + 4 * kb * BN + nl;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = n_in && ich * BK + 4 * kb + i < Cin;
          copy4(dst + i * BN, ok ? wrow + ioff + (size_t)i * Cout : wrow, ok);
        }
      }
      ist = ist + 1 == RAW ? 0 : ist + 1;
      ioff += (size_t)Cin * Cout;
      if (++itap == TAPS) {
        itap = 0;
        ++ich;
        ioff += (size_t)BK * Cout - (size_t)TAPS * Cin * Cout;
      }
    };
    auto convert = [&](int ch, int tap, int cst, unsigned char* slot) {
      float v[4][4];                         // v[i][j]: input channel 4 kb + i, output nl + j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 r;
        if constexpr (V4) {
          r = raw4(raw + cst * SM::RAW_ELEMS + (4 * kb + i) * BN + nl);
        } else {
          const int c = ch * BK + 4 * kb + i;
          const WT* src = wrow + ((size_t)tap * Cin + ch * BK + i) * Cout;
          const bool in = c < Cin;
          r.x = in && n_in ? rt::to_f32(src[0]) : 0.f;
          r.y = in && n0 + nl + 1 < Cout ? rt::to_f32(src[1]) : 0.f;
          r.z = in && n0 + nl + 2 < Cout ? rt::to_f32(src[2]) : 0.f;
          r.w = in && n0 + nl + 3 < Cout ? rt::to_f32(src[3]) : 0.f;
        }
        v[i][0] = r.x;
        v[i][1] = r.y;
        v[i][2] = r.z;
        v[i][3] = r.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (F32) {
          const tc::Split s0 = tc::split_rna(v[0][j]), s1 = tc::split_rna(v[1][j]);
          const tc::Split s2 = tc::split_rna(v[2][j]), s3 = tc::split_rna(v[3][j]);
          *reinterpret_cast<uint4*>(slot + slot_off_j[j]) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
          *reinterpret_cast<uint4*>(slot + BPLANE + slot_off_j[j]) =
              make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
        } else {
          // exact in TF32: the fp32 bits are the operand, lo is zero
          *reinterpret_cast<uint4*>(slot + slot_off_j[j]) =
              make_uint4(__float_as_uint(v[0][j]), __float_as_uint(v[1][j]),
                         __float_as_uint(v[2][j]), __float_as_uint(v[3][j]));
        }
      }
    };

    // RAW - 1 steps of weights in flight
#pragma unroll
    for (int p = 0; p < RAW - 1; ++p) {
      issue();
      tc::cp_async_commit();
    }
    int stage = 0, round = 0, cst = 0;       // step s's slot, s / STAGES, raw stage
    for (int ch = 0; ch < chunks; ++ch) {
      for (int tap = 0; tap < TAPS; ++tap) {
        tc::cp_async_wait<RAW - 2>();        // this thread's copies of the step's weights
        if (round > 0) tc::mbar_wait(&wempty[stage], (round - 1) & 1);
        convert(ch, tap, cst, slots + stage * SM::SLOT_BYTES);
        tc::fence_proxy_async();             // the slot, for the wgmmas that read it
        tc::mbar_arrive(&wfull[stage]);
        issue();
        tc::cp_async_commit();
        cst = cst + 1 == RAW ? 0 : cst + 1;
        if (++stage == STAGES) {
          stage = 0;
          ++round;
        }
      }
    }
    return;
  }

  // -- warpgroup 1, the halo producer ---------------------------------------
  if (warp < 8) {
    tc::regs_lower<PRODUCER_REGS>();
    const int hw = warp - 4;                 // this warp's channel group
    // warp w stages channels 4 w..4 w + 3 of each chunk, lane l the halo
    // pixels l + 32 j: copied raw by cp.async (zeros outside the image or
    // past Cin) two chunks ahead, then passed through the prologue and
    // split by the thread that copied them
    const float* const x = a.x + (size_t)img * H * W * Cin + 4 * hw;
    const float2* const stats =
        PRO ? reinterpret_cast<const float2*>(a.stats) + img * a.G : nullptr;
    const int cpg = PRO ? Cin / a.G : 1;
    constexpr int J = (HPIX + 31) / 32;                  // halo pixels a lane
    constexpr int JP = 3;                                // ... processed at once
    float* const rawh = reinterpret_cast<float*>(sm + SM::RAWH_OFF) + hw * HPIX * 4;
    // this lane's halo pixels: their offsets in x, and which lie in the image
    int hoff[J];
    unsigned inside = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = lane + 32 * j;
      const int gy = y0 + p / HWD - 1, gx = x0 + p % HWD - 1;
      const bool in = p < HPIX && gy >= 0 && gy < H && gx >= 0 && gx < W;
      hoff[j] = in ? (gy * W + gx) * Cin : 0;
      inside |= (unsigned)in << j;
    }
    auto copy_halo = [&](int ch) {
      if (ch >= chunks) return;
      float* const dst = rawh + (ch % RAW_HALOS) * (PLANE_BYTES / 4);
      const int c = ch * BK + 4 * hw;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = lane + 32 * j;
        if (p >= HPIX) break;
        const bool in = (inside >> j) & 1;
        const float* px = x + hoff[j] + ch * BK;
        if constexpr (V4) {
          tc::cp_async16(dst + p * 4, px, in && c < Cin);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) tc::cp_async4(dst + p * 4 + i, px + i, in && c + i < Cin);
        }
      }
    };
    // this warp's four channels of a chunk: the GroupNorm scale and shift
    float sc[4], sh[4];
    auto params = [&](int ch) {
      if constexpr (PRO == kGnSilu) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ch * BK + 4 * hw + i;
          const bool in = c < Cin;
          const float2 st = in ? __ldg(stats + c / cpg) : make_float2(0.f, 0.f);
          sc[i] = in ? st.y * __ldg(a.gamma + c) : 0.f;
          sh[i] = in ? fmaf(-st.x, sc[i], __ldg(a.beta + c)) : 0.f;
        }
      }
    };
    // this lane's pixels j0..j1-1 of chunk ch: through the prologue (zero
    // outside the image AFTER it: the SAME ring), split into the chunk's hi
    // and lo planes, 16 bytes each
    auto process = [&](int ch, int j0, int j1) {
      const float* const src = rawh + (ch % RAW_HALOS) * (PLANE_BYTES / 4);
      unsigned char* const buf = halo + (ch % HALO_BUFS) * SM::HALO_BYTES + hw * KG_BYTES;
#pragma unroll
      for (int u = 0; u < JP; ++u) {
        const int j = j0 + u, p = lane + 32 * j;
        if (j >= j1 || p >= HPIX) continue;
        float4 v = *reinterpret_cast<const float4*>(src + p * 4);
        if constexpr (PRO == kGnSilu) {
          // all ones in the image, zeros outside: a select without a branch
          // (a branch around each value's chain would serialise the four)
          const int keep = -(int)((inside >> j) & 1);
          auto act = [&](float xv, int i) {
            const float t = fmaf(xv, sc[i], sh[i]);
            // t * sigmoid(t); -0 for t -> -inf; 0 past Cin (scale, shift 0)
            const float r = __fdividef(t, 1.f + __expf(-t));
            return __int_as_float(__float_as_int(r) & keep);
          };
          v = make_float4(act(v.x, 0), act(v.y, 1), act(v.z, 2), act(v.w, 3));
        }
        const tc::Split s0 = tc::split_rna(v.x), s1 = tc::split_rna(v.y), s2 = tc::split_rna(v.z),
                        s3 = tc::split_rna(v.w);
        *reinterpret_cast<uint4*>(buf + p * 16) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
        *reinterpret_cast<uint4*>(buf + PLANE_BYTES + p * 16) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
      }
    };

    // the first two chunks in flight; then each chunk in turn, two ahead
#pragma unroll
    for (int c = 0; c < RAW_HALOS; ++c) {
      copy_halo(c);
      tc::cp_async_commit();
    }
    for (int ch = 0; ch < chunks; ++ch) {
      params(ch);
      tc::cp_async_wait<RAW_HALOS - 1>();    // this thread's copies of chunk ch
      if (ch >= HALO_BUFS) tc::mbar_wait(&hempty[ch % HALO_BUFS], (ch / HALO_BUFS - 1) & 1);
      for (int j0 = 0; j0 < J; j0 += JP) process(ch, j0, J);
      tc::fence_proxy_async();               // the halo, for the wgmmas that read it
      tc::mbar_arrive(&hfull[ch % HALO_BUFS]);
      copy_halo(ch + RAW_HALOS);             // into chunk ch's raw buffer
      tc::cp_async_commit();
    }
    return;
  }

  // -- consumers: 64 pixels of row y0 + cw x 128 channels each.  A chunk's
  // products are one chain in a fresh accumulator: every step issues the
  // same products and waits only for the step before it (whose slot it
  // then frees), so the tensor core always has the next step queued; the
  // chunk's end waits for its last step and adds the chain to the sum.
  // No accumulator register is touched while a product is in flight, and
  // no product is issued conditionally: ptxas would serialise them all.
  tc::regs_raise<CONSUMER_REGS>();
  const int cw = warp / 4 - 2, wq = warp % 4, g = lane / 4, t = lane % 4;
  float acc[BN / 2], d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // descriptors of the halo's and the slots' first bytes; an operand's is
  // its base's plus its offset in 16-byte units (shared memory addresses
  // stay below 256 KB, so the address field never carries)
  const uint64_t adesc = tc::make_desc(halo, KG_BYTES, 128);
  const uint64_t bdesc = tc::make_desc(slots, 128, SBO);
  int stage = 0, round = 0;                  // step s's slot, s / STAGES
  for (int ch = 0; ch < chunks; ++ch) {
    tc::mbar_wait(&hfull[ch % HALO_BUFS], (ch / HALO_BUFS) & 1);
    const uint64_t ah = adesc + (uint64_t)(((ch % HALO_BUFS) * SM::HALO_BYTES + cw * HWD * 16) >> 4);
    const uint64_t al = ah + (PLANE_BYTES >> 4);
    tc::fence_regs<BN / 2>(d);
    int prev = 0;                            // the step before's slot
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      tc::mbar_wait(&wfull[stage], round & 1);
      const int ry = TAPS == 9 ? tap / 3 : pi + tap / 2;   // the tap's halo offset
      const int cx = TAPS == 9 ? tap % 3 : pj + tap % 2;
      const uint64_t pa = (uint64_t)(((ry * HWD + cx) * 16) >> 4);   // the warpgroup's first pixel
      const uint64_t a0 = pa, a8 = pa + ((2 * KG_BYTES) >> 4);      // slices k 0-7, 8-15
      const uint64_t bh = bdesc + (uint64_t)((stage * SM::SLOT_BYTES) >> 4);
      const uint64_t b8 = (8 / 4 * 128) >> 4;
      tc::wgmma_fence();
      // slices past Cin add exact zeros (zero halo and weights)
      if constexpr (F32) {
        const uint64_t bl = bh + (BPLANE >> 4);
        tc::wgmma_m64n128k8_tf32_ss(d, al + a0, bh, tap > 0);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a0, bl, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a0, bh, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, al + a8, bh + b8, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a8, bl + b8, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a8, bh + b8, 1);
      } else {
        tc::wgmma_m64n128k8_tf32_ss(d, al + a0, bh, tap > 0);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a0, bh, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, al + a8, bh + b8, 1);
        tc::wgmma_m64n128k8_tf32_ss(d, ah + a8, bh + b8, 1);
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();                   // the step before's products are done
      if (tap > 0) {
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(&wempty[prev]);
      }
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        ++round;
      }
    }
    tc::wgmma_wait<0>();                     // the chain is done: free slot and halo, add
    tc::fence_regs<BN / 2>(d);
    __syncwarp();
    if (lane == 0) {
      tc::mbar_arrive(&wempty[prev]);
      tc::mbar_arrive(&hempty[ch % HALO_BUFS]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += d[i];
  }

  // -- epilogue: scale, bias, four consecutive channels per thread, float4 --
  const bool even = (t & 1) == 0;
  float* out = static_cast<float*>(a.out);
  const int OH = TAPS == 4 ? 2 * H : H, OW = TAPS == 4 ? 2 * W : W;
  const int y = y0 + cw;
  const int xx = x0 + 16 * wq + g + (even ? 0 : 8);
  const int oy = TAPS == 4 ? 2 * y + pi : y, ox = TAPS == 4 ? 2 * xx + pj : xx;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float* c = acc + 4 * j;
    // even lanes take pixel g's pair from the odd neighbour, odd lanes
    // pixel g+8's from the even one
    const float px = __shfl_xor_sync(0xffffffffu, even ? c[2] : c[0], 1);
    const float py = __shfl_xor_sync(0xffffffffu, even ? c[3] : c[1], 1);
    const int cb = n0 + 8 * j + 2 * (t & ~1);
    float v[4] = {c[0], c[1], px, py};
    if (!even) {
      v[0] = px;
      v[1] = py;
      v[2] = c[2];
      v[3] = c[3];
    }
    if (y >= H || xx >= W) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = cb + k < Cout;
      if (rt::Scaled<WT>::value) v[k] = __fmul_rn(v[k], in ? __ldg(a.wscale + cb + k) : 0.f);
      v[k] += in ? __ldg(a.bias + cb + k) : 0.f;
    }
    float* o = out + (((size_t)img * OH + oy) * OW + ox) * Cout + cb;
    if ((Cout & 3) == 0 && cb + 3 < Cout) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cb + k < Cout) o[k] = v[k];
    }
  }
}

template <int PRO, int TAPS, int V4, class WT>
int launch_tile(const rt::ConvArgs& a, cudaStream_t stream) {
  constexpr int SMEM_BYTES = Smem<WT>::BYTES;
  auto kernel = wg_conv_kernel<PRO, TAPS, V4, WT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers between the warpgroups within the block's
  // allocation: unless the block holds the whole register file, the
  // consumers' request could wait forever
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs * Smem<WT>::NT != 65536) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(((a.H + NC - 1) / NC) * ((a.W + TW - 1) / TW),
                  ((a.Cout + BN - 1) / BN) * (TAPS == 4 ? 4 : 1), a.N);
  kernel<<<grid, Smem<WT>::NT, SMEM_BYTES, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int PRO, class WT>
bool vec4(const rt::ConvArgs& a) {
  uintptr_t p = reinterpret_cast<uintptr_t>(a.x);
  if (PRO == kGnSilu)
    p |= reinterpret_cast<uintptr_t>(a.gamma) | reinterpret_cast<uintptr_t>(a.beta);
  return a.Cin % 4 == 0 && p % 16 == 0 && a.Cout % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a.w) % (4 * sizeof(WT)) == 0;
}

// The tile, at layout kRule or kRows2.  a.N <= 65535, a.Cout > 0.
template <int PRO, int TAPS, class WT>
int launch(const rt::ConvArgs& a, int layout, cudaStream_t stream) {
  if (layout != kRule && layout != kRows2) return (int)cudaErrorInvalidValue;
  if (rt::Scaled<WT>::value && a.wscale == nullptr) return (int)cudaErrorInvalidValue;
  return vec4<PRO, WT>(a) ? launch_tile<PRO, TAPS, 1, WT>(a, stream)
                          : launch_tile<PRO, TAPS, 0, WT>(a, stream);
}

// One wgmma TF32 product, D [64 x 128] = A [64 x 8] B [8 x 128] (row-major
// fp32, each value used as its TF32 bits), A laid out as a halo plane of
// 64 pixels and B as a weight slot, through the tile's descriptors: a
// check of the operand layouts against a product on the CPU.  One block of
// 128 threads.
__global__ void __launch_bounds__(128) wgmma_tf32_probe_kernel(const float* A, const float* B,
                                                               float* D) {
  constexpr int KG = 64 * 16;                       // 4 channels at 64 pixels
  __shared__ __align__(128) unsigned char plane[BPLANE];
  __shared__ __align__(128) unsigned char apl[2 * KG];
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  for (int e = tid; e < 8 * BN; e += 128) {
    const int k = e / BN, n = e % BN;
    *reinterpret_cast<uint32_t*>(plane + slot_off(n, k)) = __float_as_uint(B[e]);
  }
  for (int e = tid; e < 64 * 8; e += 128) {
    const int m = e / 8, k = e % 8;
    *reinterpret_cast<uint32_t*>(apl + (k / 4) * KG + m * 16 + (k % 4) * 4) = __float_as_uint(A[e]);
  }
  tc::fence_proxy_async();
  __syncthreads();
  float d[BN / 2];
  tc::fence_regs<BN / 2>(d);
  tc::wgmma_fence();
  tc::wgmma_m64n128k8_tf32_ss(d, halo_desc(apl, KG, 0, 0), slice_desc(plane, 0), 0);
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs<BN / 2>(d);
  const int r = 16 * w + g;
  for (int j = 0; j < BN / 8; ++j) {
    D[r * BN + 8 * j + 2 * t] = d[4 * j];
    D[r * BN + 8 * j + 2 * t + 1] = d[4 * j + 1];
    D[(r + 8) * BN + 8 * j + 2 * t] = d[4 * j + 2];
    D[(r + 8) * BN + 8 * j + 2 * t + 1] = d[4 * j + 3];
  }
}

}  // namespace wgc
