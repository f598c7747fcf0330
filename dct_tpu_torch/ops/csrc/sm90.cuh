// Device helpers for the port's Hopper (sm_90a) kernels: shared-memory
// matrix descriptors, wgmma wrappers (bf16 or TF32 in, f32 accumulators),
// the wgmma and async-proxy fences, cp.async copies (bf16 tiles, raw f32
// rows), the swizzle of 32-, 64- and 128-byte rows, the 3xTF32 split of an
// f32 value and of f32 rows, and the KV tile range of a q tile under the
// causal mask and window.
//
// Tile layout.  A [ROWS][D] tile of E-byte elements (bf16: E = 2; f32 as
// TF32: E = 4) is kept in shared memory the way wgmma reads a swizzled
// operand: rows of RB = min(128, E*D) bytes, so a wider tile is split into
// panels of 128 / E columns (panel p holds columns p*128/E.. of every row,
// ROWS*128 bytes each).  Inside a panel the 16-byte chunk c of row r sits
// where Swizzle<B,4,3> puts it: address bits [4, 4+B) XOR bits [7, 7+B),
// B = log2(RB / 16).  Every tile starts on a 1024-byte boundary, so the
// swizzle (a function of the address) is the one the descriptor's layout
// type names.
//
// One bf16 tile serves as either operand orientation:
// - K-major (K = D along the row; S = Q.K^T, K.Q^T, V.dO^T): 8-row groups
//   SBO = 8*RB apart, and k-step kk starts 32*kk bytes into its panel (the
//   hardware swizzles the advanced address as it swizzled the stored one);
// - MN-major (K along the rows, N = D; P.V, P^T.dO, dS^T.Q, dS.K): k-step
//   kk starts 16*kk rows in, 8-row groups SBO = 8*RB apart, and the second
//   64-column panel (N = 128) LBO = ROWS*RB further.
// TF32 has no transpose: both of its operands are K-major, a k-step is 8
// values (32 bytes, as for bf16), and an operand whose K runs down the
// rows in device memory (V in P.V) is stored transposed.
//
// Accumulator layout of an m64nN wgmma: thread t of the warpgroup (warp
// w = t / 32, lane l) holds d[4j + 2i + c] = D[16w + l/4 + 8i][8j + 2(l%4) + c]
// for i, c in {0, 1}.  For bf16 this is also the register A operand's
// layout, so a score accumulator packed pairwise to bf16x2 (pack_a) is the
// A operand of the next product, k-step kk in registers 4kk..4kk+3.  The
// TF32 A operand of k-step j (columns 8j..8j+7) is laid out otherwise:
// a0, a1, a2, a3 = A[16w + l/4 (+8 for a1, a3)][8j + l%4 (+4 for a2, a3)].
// With the columns of each 8-group permuted, k = l%4 + 4c standing for
// accumulator column 2(l%4) + c, the accumulator's (d[4j], d[4j+2],
// d[4j+1], d[4j+3]) are that operand: see tf32_key.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4), layout type (1 = 128B, 2 = 64B, 3 = 32B swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

template <int D, int ROWS, int E = 2>
struct Tile {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "columns");
  static_assert(ROWS % 8 == 0, "whole 8-row groups");
  static_assert(E == 2 || E == 4, "bf16 or TF32");
  static constexpr int RB = E * D < 128 ? E * D : 128;  // bytes per row
  static constexpr int SWZ = RB == 128 ? 3 : RB == 64 ? 2 : 1;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int PANEL = ROWS * RB;  // bytes per panel
  static constexpr int BYTES = ROWS * D * E;
  static constexpr int CHUNKS = D * E / 16;  // 16-byte chunks per row

  // Byte offset of the 16-byte chunk c (columns 16c/E..) of row r.
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    constexpr int per = RB / 16;
    const uint32_t off = (c / per) * PANEL + r * RB + (c % per) * 16;
    return off ^ (((off >> 7) & ((1u << SWZ) - 1)) << 4);
  }
  // The tile as a K-major operand, k-step kk (32 bytes: 16 bf16 or 8
  // TF32 columns).
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    const int b = 32 * kk;
    return make_desc(base + (b / RB) * PANEL + b % RB, 16, 8 * RB, LAYOUT);
  }
  // The tile as an MN-major operand (N = D), k-step kk (rows 16kk..+15);
  // bf16 only.
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    static_assert(E == 2, "TF32 operands are K-major only");
    return make_desc(base + 16 * kk * RB, PANEL, 8 * RB, LAYOUT);
  }
};

// ---- asynchronous copies -------------------------------------------------

// 16 bytes global -> shared; with valid false the destination is zeroed
// (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeroed when not valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0..row0+ROWS-1 of a [seq][D] bf16 matrix into a swizzled Tile
// (rows at or past seq are zeroed), one 16-byte cp.async per chunk,
// spread over NT threads; neighbouring threads copy neighbouring chunks.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int seq, int tid) {
  using T = Tile<D, ROWS>;
  static_assert(ROWS * T::CHUNKS % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * T::CHUNKS / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / T::CHUNKS, c = i % T::CHUNKS;
    const bool ok = row0 + r < seq;
    cp_async16(dst + T::chunk(r, c),
               src + (size_t)(ok ? row0 + r : 0) * D + 8 * c, ok);
  }
}

// ---- fences --------------------------------------------------------------

// Make this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order register and shared-memory accesses before the wgmmas that follow
// (needed whenever an accumulator or a register A operand was written).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns the registers.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x, opaque to the compiler.  A tile address laundered once per loop
// iteration is not loop-invariant, so the wgmma descriptors computed from
// it are not hoisted out of the loop, one register pair per k-step and
// tile, which spills a kernel whose tiles are all at fixed addresses.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// ---- math ----------------------------------------------------------------

// 2^x on the SFU: one ex2.approx.ftz (about 2 ulp; -inf gives +0), where
// exp2f adds range handling for subnormal results around the same
// instruction.  The softmax's exponentials are its instruction budget.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- 3xTF32 ---------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as the bits
// of an f32.  Rounded here, not left to the tensor core, which would
// truncate the low 13 bits.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo to about 2^-22 of x: hi = tf32(x), lo = tf32(x - hi) (the
// difference is exact in f32).  A product is then hi.hi + hi.lo + lo.hi,
// three TF32 products with lo.lo (about 2^-22 of it) dropped.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// split_tf32 of four values (a 16-byte chunk of an f32 row).
__device__ __forceinline__ void split_tf32x4(const float4& x, uint4& hi,
                                             uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// Rows row0..row0+ROWS-1 of a [seq][D] f32 matrix into a raw row-major
// tile at dst (16-byte chunk i at 16*i; rows at or past seq zeroed), one
// 16-byte cp.async per chunk, spread over NT threads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src,
                                              int row0, int seq, int tid) {
  constexpr int CH = D / 4;  // 16-byte chunks of an f32 row
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / CH;
    const bool ok = row0 + r < seq;
    cp_async16(dst + 16 * i,
               src + (size_t)(ok ? row0 + r : 0) * D + 4 * (i % CH), ok);
  }
}

// Rows row0..row0+ROWS-1 of a [seq][D] f32 matrix, read once from device
// memory and split as stored into TF32 hi and lo tiles of 64 rows each
// (Tile<D, 64, 4>): rows 64w.. into the hi tile at dst + w * stride and
// the lo tile after it; rows past seq are zero.  gbase is the generic
// pointer of the shared address base; NT threads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void split_rows(uint8_t* gbase, uint32_t base,
                                           uint32_t dst, uint32_t stride,
                                           const float* src, int row0,
                                           int seq, int tid) {
  using T = Tile<D, 64, 4>;
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D +
                                           4 * c);
    uint4 hi, lo;
    split_tf32x4(x, hi, lo);
    const uint32_t t = dst + (r / 64) * stride + T::chunk(r % 64, c);
    *reinterpret_cast<uint4*>(gbase + (t - base)) = hi;
    *reinterpret_cast<uint4*>(gbase + (t - base) + T::BYTES) = lo;
  }
}

// The key of an 8-key group that the k index kp of a TF32 register A
// operand built from an accumulator stands for (see the header):
// kp = 0..3 -> keys 0, 2, 4, 6; kp = 4..7 -> keys 1, 3, 5, 7.  The B
// operand of the same product stores its key kp's values at position kp.
__device__ __forceinline__ int tf32_key(int kp) {
  return 2 * (kp & 3) + (kp >> 2);
}

// ---- attention tiles -------------------------------------------------------

// The KV tiles of `bk` keys that the q rows q0..q0+rows-1 need: j_lo and
// the count.  Causal stops at the diagonal; a window starts at the tile
// holding the first key of the band of row q0 (the TPU kernels' clamped
// index maps, dct_tpu/ops/pallas_attention.py:218-235, as loop bounds).
__device__ __forceinline__ int kv_tiles(int q0, int rows, int bk, int seq,
                                        int causal, int window, int& j_lo) {
  const int q_last = min(q0 + rows, seq) - 1;
  int j_hi = (seq + bk - 1) / bk - 1;
  j_lo = 0;
  if (causal) {
    j_hi = q_last / bk;
    if (window > 0) j_lo = max(0, q0 - window + 1) / bk;
  }
  return j_hi - j_lo + 1;
}

// ---- fragments -----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN f32 accumulator rounded to bf16 as the register A operand of
// a product over K = N: k-step kk is a[4kk..4kk+3].
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[R / 2],
                                       const float (&d)[R]) {
#pragma unroll
  for (int n = 0; n < R / 2; ++n) a[n] = pack_bf16(d[2 * n], d[2 * n + 1]);
}

// ---- wgmma ---------------------------------------------------------------

// D[64x64] (+)= A[64x16] B[16x64], A and B from shared memory, both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64xN] (+)= A[64x16] B[16xN] for N = 16, 32, 64, 128: A from registers
// (an accumulator of this layout packed to bf16x2, see pack_a), B from
// shared memory MN-major (the transpose bit); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_rs_n<N> by N; (a0, a1, a2, a3) is one k-step of a pack_a operand.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db,
                                         int scale_d) {
  const uint32_t a[4] = {a0, a1, a2, a3};
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

// ---- wgmma, TF32 ----------------------------------------------------------

// D[64xN] (+)= A[64x8] B[8xN] in TF32 for N = 16, 32, 64 (f32 bits; the
// low 13 mantissa bits are ignored, so callers round first: split_tf32), A
// and B from shared memory, both K-major (TF32 has no transpose); scale_d =
// 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_tf32_n16(float (&d)[8], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma_ss_tf32_n<N> by N.
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_tf32_n16(d, da, db, scale_d);
  else if constexpr (N == 32) wgmma_ss_tf32_n32(d, da, db, scale_d);
  else wgmma_ss_tf32_n64(d, da, db, scale_d);
}

// D[64xN] (+)= A[64x8] B[8xN] in TF32 for N = 16, 32, 64: A from
// registers in the TF32 fragment layout (see the header), B from shared
// memory K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_tf32_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// wgmma_rs_tf32_n<N> by N; (a0, a1, a2, a3) is one k-step of the A operand.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db,
                                              int scale_d) {
  const uint32_t a[4] = {a0, a1, a2, a3};
  if constexpr (N == 16) wgmma_rs_tf32_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_tf32_n32(d, a, db, scale_d);
  else wgmma_rs_tf32_n64(d, a, db, scale_d);
}

}  // namespace sm90
