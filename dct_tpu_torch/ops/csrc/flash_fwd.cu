// Flash-attention forward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: dct_tpu/ops/pallas_attention.py `_flash_fwd_kernel` (:81-171),
// driven by `_flash_fwd` (:174-281, the pl.pallas_call at :260).
//
// Computes, per (batch, q head): o = softmax(scale * q k^T, masked) v, with
// - the causal mask and the causal sliding window (attend iff
//   0 <= q_pos - k_pos < window), and the TPU kernel's fully-masked-row guard;
// - grouped-query attention: q head h reads kv head h / (H / G) (the
//   group-major layout of `_kv_flat_row`); K/V are never expanded in memory;
// - rectangular Tq != Tk (not causal: the striped ring's half-chunk blocks)
//   and `q_offset`, the shift of the q positions under the causal mask and
//   window (the windowed ring's partial-band shards, :84, :117-119,
//   :152-157): row r sits at position q_offset + r, the keys at 0..Tk-1.
//   A row that no key reaches gets o = 0 and lse = -1e30, the TPU kernel's
//   fully-masked-row guard;
// - the optional per-row log-sum-exp lse = m + log(l), f32;
// - f32 or bf16 inputs, f32 accumulation; P is rounded to the input dtype
//   before P.V exactly where the TPU kernel casts it (`:140-143`; in f32 it
//   stays f32), and the scale is applied after q k^T.
//
// What bounds it on this card.  At the serving shape (B=32, H=G=8, T=1024,
// D=64) the work is 4*B*H*T^2*D = 68.7 GFLOP (about half with causal) and the
// compulsory traffic is (2*B*H*T + 2*B*G*T)*D*itemsize = 268 MB in f32,
// 134 MB in bf16.  Against the H100 datasheet (3.35 TB/s; 989 TFLOP/s bf16
// and 495 TFLOP/s TF32 dense on the tensor cores) the bf16 case sits near
// the ridge (0.07 ms of operations vs 0.04 ms of bytes).  f32-accurate
// products on the tensor cores take three TF32 products each (3xTF32,
// below), 165 TFLOP/s, against 67 TFLOP/s on the FMA units: the f32 case is
// bound by operations at 3 * 68.7 GFLOP / 495 TFLOP/s = 0.42 ms (vs 0.08 ms
// of bytes).
//
// What the design does about it.  The score matrix never reaches device
// memory: one warpgroup owns a 64-row q tile and walks the KV tiles in a
// loop -- the loop replaces the TPU's sequential third grid axis, and the
// causal/window tile skip becomes the loop's bounds (sm90::kv_tiles,
// replacing the clamped index maps at :218-235).  The grid is (B*H, q
// tiles).  The bf16 kernel's blocks run q-tile-major so the q tiles of one
// head share its K/V in L2 (sm90::block_row_tile); the f32 kernel's run
// head-major, the heaviest causal tiles of every head first.  Both kernels
// run the products on the tensor cores (wgmma) and the online softmax on the
// accumulator fragment (a row lives in the 4 threads of a quad: the row
// max is two shuffles, the row sum is reduced once at the end; each
// exponential is one ex2.approx on the SFU, as the softmax's instructions
// bound the kernels as much as the products do).  Each wgmma is waited on before
// the registers it writes are touched: a wgmma still in flight across the
// softmax made ptxas serialize every wgmma of the kernel.  The element
// mask runs only on diagonal, window-edge and ragged tiles.  Picked by
// dtype (helpers: sm90.cuh):
//
// - bf16: flash_fwd_kernel_wgmma.  One warpgroup (128 threads) per block.
//   The Q tile is copied once into swizzled shared memory; K/V tiles come
//   through a 2-stage ring of cp.async copies, so the next tile loads while
//   one is multiplied (shallow, so that more blocks fit an SM and overlap
//   one another's softmax and products).  S = Q.K^T takes both operands
//   from shared memory (K-major); P is rounded to bf16 in registers and is
//   the register A operand of O += P.V, with V ([keys][D] row-major) the
//   MN-major B operand.
// - f32: flash_fwd_kernel_tf32, 3xTF32.  Each operand x is split as
//   hi = tf32(x), lo = tf32(x - hi), rounded explicitly (cvt.rna), and each
//   product is hi.hi + hi.lo + lo.hi into one f32 accumulator: about 2^-22
//   of each product is lost, where single-pass TF32 loses 2^-11 and misses
//   the 1e-5 agreement by far.  The scale is applied after q k^T and P stays
//   f32, as in the TPU kernel.  Two warpgroups (D = 128: one) share each
//   KV tile.  The trouble spots and what the kernel does about them:
//   * TF32 operands have no transpose bit, so both must be K-major.  Q and
//     K as stored are; V is not (P.V sums over keys, V's rows).  K and V
//     land raw through cp.async (which cannot transpose), then a split pass
//     writes K hi/lo as they are and V hi/lo transposed, V^T [D][keys], into
//     swizzled tiles.  Q is split once, from device memory, per block.
//   * The TF32 register A fragment is not the accumulator layout.  P.V sums
//     over keys, so the split pass stores each 8-key group of V^T in the
//     order (0, 2, 4, 6, 1, 3, 5, 7) (sm90::tf32_key); in that order a
//     thread's accumulator entries of P are its A fragment, and P's hi and
//     lo go to the tensor cores from registers without a shuffle or a trip
//     through shared memory.
//   * Each k-step of a wgmma rounds the running sum to the accumulator's
//     precision at the sum's size, so when the small products are added
//     decides what of them survives.  They go first, while the sum is
//     small; and each tile's P.V goes into a fresh accumulator (64 output
//     columns at a time), added to O in f32 as O = alpha O + P.V, so that O
//     is not rounded 3 x BKT/8 times a tile at its full size.
//   * Shared memory: Q hi/lo, K hi/lo, V^T hi/lo and one raw K/V landing
//     pair (the split tiles serve as the second stage: tile t+1 lands while
//     tile t is multiplied), 160 KiB at D = 64 and D = 128 (Tf32Cfg).  Q
//     stays in shared memory, not registers: at D = 128 its hi/lo fragments
//     would take 128 registers beside the 64 of the O accumulator.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows per warpgroup
constexpr int BK = 64;         // keys per KV tile (bf16)
constexpr float NEG = -1e30f;  // finite "minus infinity", the TPU kernel's _NEG

constexpr int WG = 128;       // threads: one warpgroup
constexpr int WG_STAGES = 2;  // depth of the bf16 K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A row's log-sum-exp from its running max m (log2 units) and its sum of
// exponentials l_sum, denom = max(l_sum, 1e-20).  A row that no key
// reaches (an offset band, ragged keys) keeps l_sum = 0: its lse is NEG,
// as the TPU kernel's m + log(1e-20) is in f32, not NEG * ln 2.
__device__ __forceinline__ float row_lse(float m, float l_sum, float denom) {
  return l_sum > 0.f ? m * LN2 + logf(denom) : NEG;
}

// ---- bf16: tensor cores (wgmma) ------------------------------------------

// Q tile, then WG_STAGES x (K tile, V tile), each 1024-byte aligned.
template <int D>
struct WgSmem {
  using Tl = sm90::Tile<D, BQ>;
  static constexpr size_t bytes = 1024 + Tl::BYTES * (1 + 2 * WG_STAGES);
};

template <int D>
__global__ void __launch_bounds__(WG)
    flash_fwd_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int G, int tq,
                           int tk, int q_offset, float scale, int causal,
                           int window) {
  static_assert(BQ == 64 && BK == 64, "one m64n64 score tile per KV tile");
  using Tl = sm90::Tile<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + Tl::BYTES;  // stage s: K at +2s tiles, V after

  const int tid = threadIdx.x;
  // Heaviest causal tiles first (the last q tiles see the most keys).
  const sm90::RowTile rt = sm90::block_row_tile();  // tile-fastest
  const int qt = gridDim.y - 1 - rt.tile;
  const int bh = rt.row;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQ;
  const int qp0 = q_offset + q0;  // the tile's first q position
  const __nv_bfloat16* kb = k + (size_t)kvh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)kvh * tk * D;

  int j_lo;
  const int n_kv =
      sm90::kv_tiles(q0, BQ, BK, tq, tk, q_offset, causal, window, j_lo);

  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t % WG_STAGES) * 2 * Tl::BYTES;
    const int k0 = (j_lo + t) * BK;
    sm90::load_tile<D, BK, WG>(dst, kb, k0, tk, tid);
    sm90::load_tile<D, BK, WG>(dst + Tl::BYTES, vb, k0, tk, tid);
  };
  // Prologue: Q with KV tile 0, then tiles 1 .. WG_STAGES - 2; one commit
  // group per KV tile, empty past the last, so the ring's waits count
  // uniformly (tile t is group t).
  sm90::load_tile<D, BQ, WG>(sQ, q + (size_t)bh * tq * D, q0, tq, tid);
  load_kv(0);
  sm90::cp_async_commit();
#pragma unroll
  for (int t = 1; t < WG_STAGES - 1; ++t) {
    if (t < n_kv) load_kv(t);
    sm90::cp_async_commit();
  }

  // This thread's accumulator rows r0 and r0 + 8, columns 8j + c0 (+1).
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2, not exp
  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // Row max (log2 units) and this thread's part of the row sum.
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    sm90::cp_async_wait<WG_STAGES - 2>();
    sm90::fence_proxy_async();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1,
                      // whose stage now takes tile t + WG_STAGES - 1
    if (t + WG_STAGES - 1 < n_kv) load_kv(t + WG_STAGES - 1);
    sm90::cp_async_commit();
    const uint32_t sK = sKV + (t % WG_STAGES) * 2 * Tl::BYTES;
    const uint32_t sV = sK + Tl::BYTES;

    // S = Q K^T.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(s, Tl::kmajor(sQ, kk), Tl::kmajor(sK, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // Mask (diagonal, window-edge and ragged tiles only) and row max.  A
    // dropped pair scores -inf, so its p is exactly 0 and a row with no
    // key left in the tile keeps m = NEG and adds nothing (the TPU
    // kernel's guard).
    const int k0 = (j_lo + t) * BK;
    const bool edge =
        k0 + BK > tk ||
        (causal && (k0 + BK - 1 > qp0 ||
                    (window > 0 && qp0 + BQ - 1 - k0 >= window)));
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * sl2;
          if (edge) {
            const int qp = qp0 + r0 + 8 * i, kp = k0 + 8 * j + c0 + c;
            bool keep = kp < tk;
            if (causal) {
              keep = keep && qp >= kp;
              if (window > 0) keep = keep && qp - kp < window;
            }
            if (!keep) x = __int_as_float(0xff800000);  // -inf
          }
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = sm90::exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = sm90::exp2_approx(s[4 * j + 2 * i + c] - m[i]);
          s[4 * j + 2 * i + c] = p;
          l[i] += p;
        }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }

    // O += P V, P rounded to bf16 in registers.
    uint32_t pa[16];
    sm90::pack_a<32>(pa, s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<D>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3], Tl::mnmajor(sV, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_sum = quad_sum(l[i]);
    const float denom = fmaxf(l_sum, 1e-20f);
    const int r = q0 + r0 + 8 * i;
    if (r >= tq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                acc[4 * j + 2 * i + 1] / denom);
    if (lse != nullptr && (tid & 3) == 0)
      lse[(size_t)bh * tq + r] = row_lse(m[i], l_sum, denom);
  }
}


// ---- f32: tensor cores, 3xTF32 (wgmma) ------------------------------------

// Blocks of the 3xTF32 kernel by head dim: NWG warpgroups of 64 q rows
// share each KV tile of BKT keys (the split pass below is paid once per
// block, so two warpgroups halve it per q row).  Shared memory: Q hi/lo
// per warpgroup, K hi/lo ([keys][D]), V^T hi/lo ([D][keys]) and the raw
// K and V tiles the next copy lands in.  D <= 64: two warpgroups, 64-key
// tiles (160 KiB at D = 64); D = 128: one warpgroup, 32-key tiles (160
// KiB; 64-key tiles or a second warpgroup would need 256 or 224 KiB with
// the raw tiles, past or at the edge of the 227 KiB a block may hold).
template <int D>
struct Tf32Cfg {
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int BKT = D == 128 ? 32 : 64;
  static constexpr int NT = NWG * WG;
  using QT = sm90::Tile<D, BQ, 4>;   // one warpgroup's Q, hi or lo
  using KT = sm90::Tile<D, BKT, 4>;  // K, hi or lo: K-major for Q.K^T
  using VT = sm90::Tile<BKT, D, 4>;  // V^T, hi or lo: K-major for P.V
  static constexpr int RAW = BKT * D * 4;  // a raw K or V tile, row-major
  static constexpr size_t bytes = 1024 + 2 * NWG * QT::BYTES +
                                  2 * KT::BYTES + 2 * VT::BYTES + 2 * RAW;
};

template <int D>
__global__ void __launch_bounds__(Tf32Cfg<D>::NT)
    flash_fwd_kernel_tf32(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int G, int tq,
                          int tk, int q_offset, float scale, int causal,
                          int window) {
  using C = Tf32Cfg<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  using VT = typename C::VT;
  constexpr int BKT = C::BKT, NT = C::NT, BQB = BQ * C::NWG;
  constexpr int CH = D / 4;  // 16-byte chunks of an f32 row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t sQ = base;  // warpgroup w: hi at +2w tiles, lo after
  const uint32_t sK = sQ + 2 * C::NWG * QT::BYTES;  // hi, lo
  const uint32_t sV = sK + 2 * KT::BYTES;           // V^T hi, lo
  const uint32_t sRaw = sV + 2 * VT::BYTES;         // raw K, raw V
  auto at = [&](uint32_t addr) { return gbase + (addr - base); };

  const int tid = threadIdx.x;
  const int wg = tid / WG, wt = tid % WG;
  // Heaviest causal tiles first (the last q tiles see the most keys).
  // B*H on x (its limit is 2^31 - 1; y's is 65535), the tile on y.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQB;        // the block's first q row
  const int q0w = q0 + BQ * wg;   // this warpgroup's
  const int qp0w = q_offset + q0w;  // its first q position
  const float* kb = k + (size_t)kvh * tk * D;
  const float* vb = v + (size_t)kvh * tk * D;

  int j_lo;
  const int n_kv =
      sm90::kv_tiles(q0, BQB, BKT, tq, tk, q_offset, causal, window, j_lo);

  // Raw K and V tile t, row-major, rows past tk zeroed.
  auto load_kv = [&](int t) {
    const int k0 = (j_lo + t) * BKT;
    static_assert(BKT * CH % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int n = 0; n < BKT * CH / NT; ++n) {
      const int i = tid + n * NT;
      const int r = i / CH;
      const bool ok = k0 + r < tk;
      const size_t g = (size_t)(ok ? k0 + r : 0) * D + 4 * (i % CH);
      sm90::cp_async16(sRaw + 16 * i, kb + g, ok);
      sm90::cp_async16(sRaw + C::RAW + 16 * i, vb + g, ok);
    }
  };
  load_kv(0);
  sm90::cp_async_commit();

  // Q, read once from device memory, split into its warpgroup's hi and lo
  // tiles while KV tile 0 lands.
  {
    const float* qb = q + (size_t)bh * tq * D;
    static_assert(BQB * CH % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int n = 0; n < BQB * CH / NT; ++n) {
      const int i = tid + n * NT;
      const int r = i / CH, c = i % CH;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < tq)
        x = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * D +
                                             4 * c);
      uint4 hi, lo;
      sm90::split_tf32x4(x, hi, lo);
      const uint32_t t = sQ + (r / BQ) * 2 * QT::BYTES + QT::chunk(r % BQ, c);
      *reinterpret_cast<uint4*>(at(t)) = hi;
      *reinterpret_cast<uint4*>(at(t + QT::BYTES)) = lo;
    }
  }

  // This thread's accumulator rows r0 and r0 + 8 (of its warpgroup's 64),
  // columns 8j + c0 (+1).
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2);
  const int c0 = 2 * (wt & 3);
  const float sl2 = scale * LOG2E;  // scores in log2 units: exp2, not exp
  const uint32_t sQh = sQ + wg * 2 * QT::BYTES, sQl = sQh + QT::BYTES;
  const uint32_t sKh = sK, sKl = sK + KT::BYTES;
  const uint32_t sVh = sV, sVl = sV + VT::BYTES;
  constexpr int NC = D < 64 ? D : 64;  // output columns per P.V product
  float acc[D / 2], s[BKT / 2], pv[NC / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) pv[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_kv; ++t) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // raw tile t is in; both warpgroups are done with the
                      // split tiles of t - 1
    // The split pass.  K: each 16-byte chunk of a raw row to the same
    // chunk of the swizzled hi and lo tiles.  V: transposed, each 16-byte
    // chunk of a V^T row (4 keys of one column n) gathered from 4 raw rows,
    // the keys of each 8-group in tf32_key order.
    {
      const float* rk = reinterpret_cast<const float*>(at(sRaw));
      const float* rv = reinterpret_cast<const float*>(at(sRaw + C::RAW));
#pragma unroll
      for (int n = 0; n < BKT * CH / NT; ++n) {
        const int i = tid + n * NT;
        uint4 hi, lo;
        sm90::split_tf32x4(*reinterpret_cast<const float4*>(rk + 4 * i), hi,
                           lo);
        const uint32_t off = KT::chunk(i / CH, i % CH);
        *reinterpret_cast<uint4*>(at(sKh + off)) = hi;
        *reinterpret_cast<uint4*>(at(sKl + off)) = lo;
      }
#pragma unroll
      for (int n = 0; n < BKT * CH / NT; ++n) {
        const int i = tid + n * NT;
        const int col = i % D, c = i / D;  // V^T row col, chunk c
        const int key0 = 8 * (c / 2);
        float4 x;
        x.x = rv[(key0 + sm90::tf32_key(4 * (c % 2) + 0)) * D + col];
        x.y = rv[(key0 + sm90::tf32_key(4 * (c % 2) + 1)) * D + col];
        x.z = rv[(key0 + sm90::tf32_key(4 * (c % 2) + 2)) * D + col];
        x.w = rv[(key0 + sm90::tf32_key(4 * (c % 2) + 3)) * D + col];
        uint4 hi, lo;
        sm90::split_tf32x4(x, hi, lo);
        const uint32_t off = VT::chunk(col, c);
        *reinterpret_cast<uint4*>(at(sVh + off)) = hi;
        *reinterpret_cast<uint4*>(at(sVl + off)) = lo;
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();  // the split tiles are in; the raw tiles are free
    if (t + 1 < n_kv) load_kv(t + 1);
    sm90::cp_async_commit();

    // Skip a tile none of this warpgroup's rows sees (causal: above its
    // diagonal or past its window; ragged: no q row left).
    const int k0 = (j_lo + t) * BKT;
    const bool live =
        q0w < tq &&
        !(causal && (k0 > qp0w + BQ - 1 ||
                     (window > 0 && qp0w - (k0 + BKT - 1) >= window)));
    if (!live) continue;

    // S = Q.K^T as Qhi.Klo + Qlo.Khi + Qhi.Khi: the small products first,
    // while the sum is small, as each k-step rounds it to the accumulator's
    // precision at its size.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(s, QT::kmajor(sQh, kk), KT::kmajor(sKl, kk),
                               kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(s, QT::kmajor(sQl, kk), KT::kmajor(sKh, kk),
                               1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(s, QT::kmajor(sQh, kk), KT::kmajor(sKh, kk),
                               1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // Mask (diagonal, window-edge and ragged tiles only), row max and the
    // online softmax, as in flash_fwd_kernel_wgmma; P stays f32.
    const bool edge =
        k0 + BKT > tk ||
        (causal && (k0 + BKT - 1 > qp0w ||
                    (window > 0 && qp0w + BQ - 1 - k0 >= window)));
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * sl2;
          if (edge) {
            const int qp = qp0w + r0 + 8 * i, kp = k0 + 8 * j + c0 + c;
            bool keep = kp < tk;
            if (causal) {
              keep = keep && qp >= kp;
              if (window > 0) keep = keep && qp - kp < window;
            }
            if (!keep) x = __int_as_float(0xff800000);  // -inf
          }
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = sm90::exp2_approx(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P, split into the hi and lo A operands: k-step j is accumulator
    // columns 8j..8j+7 in tf32_key order, (d[4j], d[4j+2], d[4j+1],
    // d[4j+3]) (see sm90.cuh).
    uint32_t ph[BKT / 2], pl[BKT / 2];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = sm90::exp2_approx(s[4 * j + 2 * i + c] - m[i]);
          l[i] += p;
          sm90::split_tf32(p, ph[4 * j + 2 * c + i], pl[4 * j + 2 * c + i]);
        }
    // The tile's P.V as Phi.Vlo + Plo.Vhi + Phi.Vhi (small first, as for
    // S), V^T the K-major B operand, into a fresh accumulator of NC
    // columns at a time; then O = alpha O + P.V in f32.  Summed across the
    // tiles in the tensor cores' accumulator instead, O would be rounded
    // 3 x BKT/8 times a tile at its full size.
#pragma unroll
    for (int h = 0; h < D / NC; ++h) {
      // Columns NC*h.. of the output are rows NC*h.. of V^T.
      const uint32_t vh = sVh + NC * h * VT::RB, vl = sVl + NC * h * VT::RB;
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
        sm90::wgmma_rs_tf32<NC>(pv, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                                ph[4 * j + 3], VT::kmajor(vl, j), j);
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
        sm90::wgmma_rs_tf32<NC>(pv, pl[4 * j], pl[4 * j + 1], pl[4 * j + 2],
                                pl[4 * j + 3], VT::kmajor(vh, j), 1);
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j)
        sm90::wgmma_rs_tf32<NC>(pv, ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                                ph[4 * j + 3], VT::kmajor(vh, j), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(pv);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = 4 * j + 2 * i + c;
            acc[NC / 2 * h + n] = fmaf(acc[NC / 2 * h + n], alpha[i], pv[n]);
          }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_sum = quad_sum(l[i]);
    const float denom = fmaxf(l_sum, 1e-20f);
    const int r = q0w + r0 + 8 * i;
    if (r >= tq) continue;
    float* orow = o + ((size_t)bh * tq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i] / denom,
                      acc[4 * j + 2 * i + 1] / denom);
    if (lse != nullptr && (wt & 3) == 0)
      lse[(size_t)bh * tq + r] = row_lse(m[i], l_sum, denom);
  }
}

// The launch of either kernel: B*H on x, the q tiles on y.
struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, G, tq, tk, q_offset;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_wgmma(const FwdArgs& a) {
  auto kern = flash_fwd_kernel_wgmma<D>;
  const size_t smem = WgSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.tq + BQ - 1) / BQ);
  using bf16 = __nv_bfloat16;
  kern<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H,
      a.G, a.tq, a.tk, a.q_offset, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const FwdArgs& a) {
  using C = Tf32Cfg<D>;
  auto kern = flash_fwd_kernel_tf32<D>;
  const size_t smem = C::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.tq + BQ * C::NWG - 1) / (BQ * C::NWG));
  kern<<<grid, C::NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.G, a.tq, a.tk, a.q_offset, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// f32 -> flash_fwd_kernel_tf32; bf16 -> flash_fwd_kernel_wgmma.
template <bool BF16>
cudaError_t dispatch_dim(const FwdArgs& a, int D) {
#define DCT_FWD_CASE(DIM) \
  case DIM:               \
    return BF16 ? launch_wgmma<DIM>(a) : launch_tf32<DIM>(a);
  switch (D) {
    DCT_FWD_CASE(16)
    DCT_FWD_CASE(32)
    DCT_FWD_CASE(64)
    DCT_FWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DCT_FWD_CASE
}

}  // namespace

// q [B,H,tq,D], k/v [B,G,tk,D], o [B,H,tq,D], all contiguous, of one dtype
// (0 = f32, 1 = bf16); lse [B,H,tq] f32 or null.  Row r of q sits at
// position q_offset + r of the causal mask (q_offset >= 0); causal needs
// tq == tk (the wrapper checks).  window <= 0 means none.
extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int G, int tq,
                             int tk, int q_offset, int D, float scale,
                             int causal, int window, int dtype,
                             void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || tq <= 0 || tk <= 0 || q_offset < 0 ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q,  k,  v,  o,        static_cast<float*>(lse),
                  B,  H,  G,  tq,       tk,
                  q_offset, scale, causal, window,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_dim<false>(a, D);
  if (dtype == 1) return (int)dispatch_dim<true>(a, D);
  return (int)cudaErrorInvalidValue;
}
