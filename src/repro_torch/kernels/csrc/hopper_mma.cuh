// Tensor-core building blocks for Hopper (sm_90a), shared by the attention
// and convolution kernels: the warpgroup products (wgmma) that read a bf16
// A operand from registers and B from shared memory through a matrix
// descriptor, and the TF32 ones with both operands in shared memory (the
// decode's conv tile, wg_conv_tile.cuh; the fp32 wide attention's q k^T)
// or A from registers (its P V); the warp-level TF32 product
// (mma.sync.m16n8k8) with the hi/lo split of 3xTF32, the bf16 one
// (mma.sync.m16n8k16) with ldmatrix; the cp.async copies that stage tiles
// in shared memory, and the mbarriers that order a producer's stages
// before their consumers, within a CTA or across a cluster's CTAs; the
// TMA loads, 128-byte-swizzled descriptors and named barriers of the bf16
// flash attention (the section at the end).
//
// Shared-memory operands of wgmma use the layout without swizzle: the unit
// is a "core matrix" stored as 128 contiguous bytes, eight rows of 16
// bytes (8 x 8 bf16, or 8 x 4 TF32).  For a K-major operand (rows along M or N, K
// contiguous) a row of the core matrix is 8 consecutive K values; for an
// MN-major operand (the transposed B, as V is in P V) it is 8 consecutive
// N values of one K.  The descriptor gives the byte strides between core
// matrices along K (the leading-dimension offset) and along M/N (the
// stride-dimension offset); see make_desc().
//
// 3xTF32: an fp32 value x is carried as hi = tf32(x) and lo = tf32(x - hi)
// (both rounded to nearest, ties away from zero, as cvt.rna does); a
// product is lo*hi' + hi*lo' + hi*hi' with fp32 accumulation, which keeps
// about 22 bits of each product where one TF32 product keeps about 11.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// SMs of the current device (read once per process: a launcher chooses its
// tile by how many blocks the card runs at once); 0 if it cannot be read
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared copies that bypass registers; src_bytes 0 fills
// the destination with zeros (a tile's ragged edge)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) become
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TF32 on mma.sync
// ---------------------------------------------------------------------------

// fp32 -> tf32, rounded to nearest with ties away from zero.  cvt.rna
// leaves the 13 low bits zero (checked on the H100), so its result is the
// operand as the MMA reads it and x - hi is exact.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// fp32 bits -> tf32 bits as cvt.rna.tf32.f32 rounds them (to nearest, ties
// away from zero, on the magnitude; 13 low bits cleared), for a finite
// value, in two integer instructions (the conversion unit's cvt issues at
// a fraction of their rate): for the producers that split whole tiles
__device__ __forceinline__ uint32_t rna(uint32_t u) { return (u + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ Split split_rna(float x) {
  const uint32_t hi = rna(__float_as_uint(x));
  return {hi, rna(__float_as_uint(x - __uint_as_float(hi)))};
}

// c[16 x 8] += a[16 x 8] b[8 x 8]; a: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b: b0 (k t, n g), b1 (k t+4, n g); c: c0 (g, 2t), c1 (g,
// 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1), with g = lane / 4 and t = lane % 4
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[16 x 8] = a[16 x 8] b[8 x 8], a fresh fragment (C = 0)
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c[16 x 8] += a[16 x 16] b[16 x 8] in bf16 with fp32 accumulation (each
// product exact); a: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b: b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); c as in
// mma_tf32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two 8 x 8 matrices of 16-bit values from shared memory, one row of 16
// bytes per address (lanes 0-7 the first matrix's rows, 8-15 the
// second's); lane i gets row i / 4, columns 2 (i % 4) and 2 (i % 4) + 1 of
// each: the B fragment of mma_bf16 when the rows are B's columns
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

// four 8 x 8 matrices (lanes 8 m..8 m + 7 address matrix m) with .trans:
// lane i gets rows 2 (i % 4) and 2 (i % 4) + 1 of column i / 4 of each,
// the B fragment of mma_bf16 when the rows are B's rows (k)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// c += a b in 3xTF32 within the tensor core's accumulator: the two small
// cross terms, then hi * hi.  Only for a short chain of steps into a fresh
// fragment, which is then added to the sum on the CUDA cores (see below).
__device__ __forceinline__ void mma_3xtf32_chain(float* c, const uint32_t* ahi, const uint32_t* alo,
                                                 const uint32_t* bhi, const uint32_t* blo) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

// c[j] += a b[j] in 3xTF32 for N fragments that share the A operand: the
// two small cross terms, then hi * hi, summed in a fresh fragment that is
// then added to c[j] on the CUDA cores.  The tensor core does not round to
// nearest when it adds into its accumulator: chained there over the
// thousands of steps of a wide conv, the sum drifts all one way, by up to
// an ulp of c per step, far enough to fail the 1e-4 fp32 tolerance (the
// Cin = 520 conv case of tests/test_torch_cuda.py); a round-to-nearest add
// after each short chain does not drift.  Each MMA waits for the one
// before it in its chain, so the N chains are issued side by side, one
// product of each in turn; each fragment's own order is unchanged.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&c)[N][4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[N][2],
                                           const uint32_t (&blo)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32_zero(d[j], alo, bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ahi, blo[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ahi, bhi[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += d[j][i];
}

// mma_3xtf32 where each b[j] is exact in TF32 (a bf16 weight, or an
// integer code of at most 11 bits): b's lo half is zero, so of the three
// products only a_lo b and a_hi b remain, and dropping a_hi b_lo changes
// no bit (it adds exact zeros).  Same fresh fragments, order and
// round-to-nearest adds.
template <int N>
__device__ __forceinline__ void mma_2xtf32(float (&c)[N][4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&b)[N][2]) {
  float d[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32_zero(d[j], alo, b[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], ahi, b[j]);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] += d[j][i];
}

// ---------------------------------------------------------------------------
// wgmma (bf16 in, fp32 accumulators); D fragments: warp w of the warpgroup
// owns rows 16w..16w+15, and for each 8-column chunk j the thread holds
// d[4j..4j+3] at (g, 8j+2t), (g, 8j+2t+1), (g+8, 8j+2t), (g+8, 8j+2t+1)
// ---------------------------------------------------------------------------

// matrix descriptor of a no-swizzle operand at p: lbo = byte stride between
// core matrices along K, sbo = along M/N
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFFu) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 8] B[8 x 128] in TF32, both from shared memory
// through descriptors, both K-major (wgmma transposes no 32-bit operand): a
// no-swizzle core matrix is 8 rows (m or n) of 16 bytes (4 k), the two
// along K lbo bytes apart, those of the next 8 rows sbo.  accumulate 0
// starts a fresh sum (scale-d 0), 1 adds to D.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float* d, uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, both K-major from shared
// memory through descriptors, as wgmma_m64n128k8_tf32_ss (the fp32 wide
// attention's q k^T over a 64-key tile)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float* d, uint64_t da, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] in TF32, A from registers (the
// m16n8k8 TF32 A fragment of each warp's 16 rows: a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4)), B K-major from shared memory (the fp32
// wide attention's P V, P split in registers)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float* d, const uint32_t* a, uint64_t db,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// a warpgroup's registers a thread, lowered or raised (setmaxnreg): the
// whole warpgroup runs it; a raise waits until others' lowering frees them
template <int N>
__device__ __forceinline__ void regs_lower() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_raise() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// mbarriers in shared memory: a phase completes when `count` threads have
// arrived; a wait names the parity of the phase it waits for (0 for the
// first completion, then 1, 0, ...)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive with release semantics: this thread's earlier reads and writes of
// shared memory are ordered before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the phase of this parity to complete (a waiting thread sleeps
// until it does, up to the 10 ms hint, then tries again)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_AGAIN:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1, %2;\n"
      "@!done bra WAIT_AGAIN;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(0x989680)
      : "memory");
}

// The same across the CTAs of a cluster: arrive on the barrier at `bar`'s
// offset in the shared memory of CTA `rank` (release at cluster scope:
// this thread's earlier reads and writes, and those ordered before them,
// come first), and wait on a local barrier that other CTAs arrive on
// (acquire at cluster scope: their writes before the arrive are then seen)
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_CLUSTER:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1, %2;\n"
      "@!done bra WAIT_CLUSTER;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "r"(0x989680)
      : "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] in bf16, both K-major from shared
// memory through no-swizzle descriptors (the backward's S, S^T, dP and
// dP^T: A the rows of the product, B its columns, the head dim deepest)
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// ---------------------------------------------------------------------------
// TMA, 128-byte swizzle and the bf16 flash attention's products
// (flash_attention.cu, namespace tma)
//
// A TMA box of 64 bf16 columns (128 bytes a row) lands in shared memory in
// the 128-byte swizzle: row r's 16-byte chunk c sits at chunk c ^ (r % 8) of
// its row, rows 128 bytes apart, the pattern repeating every 8 rows (1024
// bytes, so a box starts 1024-aligned).  That is wgmma's canonical SW128
// layout: K-major (Q, K: rows along M or N, the head dim contiguous), 8-row
// groups `sbo` = 1024 bytes apart, a k16 step 32 bytes on within the row; or
// MN-major (V as the B operand of P V: the head dim, N, contiguous), 64-wide
// N atoms `lbo` bytes apart and 8-key groups `sbo` = 1024 bytes apart.
// ---------------------------------------------------------------------------

// matrix descriptor of a 128-byte-swizzled operand at p (layout type 1)
__device__ __forceinline__ uint64_t make_desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return make_desc(p, lbo, sbo) | (1ull << 62);
}

// arrive on a barrier and add `bytes` to the transactions its phase waits
// for (the TMA loads that complete on it)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first,
// into shared memory at dst; completes `bar`'s transactions by the box's
// bytes (elements outside the tensor arrive as zeros)
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: sync
// waits until n threads have arrived, arrive counts this warp and goes on
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128] in bf16, both K-major from shared
// memory through descriptors (q k^T: A the query rows, B the keys)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 80] (+)= A[64 x 16] B[16 x 80] in bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory through
// a descriptor, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n80k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 96] (+)= A[64 x 16] B[16 x 96] in bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory through
// a descriptor, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 112] (+)= A[64 x 16] B[16 x 112] in bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory through
// a descriptor, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n112k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128] in bf16, A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory through
// a descriptor, MN-major if TB
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// O[64 x N] (+)= P[64 x 16] V[16 x N] in bf16 for the head dims the TMA
// kernel instantiates, P from registers, V MN-major
template <int N>
__device__ __forceinline__ void wgmma_pv_bf16(float* d, const uint32_t* a, uint64_t db,
                                              int accumulate) {
  if constexpr (N == 64) wgmma_m64n64k16_rs<1>(d, a, db, accumulate);
  else if constexpr (N == 80) wgmma_m64n80k16_rs<1>(d, a, db, accumulate);
  else if constexpr (N == 96) wgmma_m64n96k16_rs<1>(d, a, db, accumulate);
  else if constexpr (N == 112) wgmma_m64n112k16_rs<1>(d, a, db, accumulate);
  else wgmma_m64n128k16_rs<1>(d, a, db, accumulate);
}

}  // namespace tc
