// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: dct_tpu/ops/pallas_attention.py, driven by `_flash_bwd`
// (:427-544):
// - `_flash_bwd_dkdv_kernel` (:303-370, the pl.pallas_call at :487) ->
//   flash_bwd_dkdv_kernel_wgmma (bf16) and flash_bwd_dkdv_kernel_tf32 (f32);
// - `_flash_bwd_dq_kernel` (:373-424, the pl.pallas_call at :529) ->
//   flash_bwd_dq_kernel_wgmma (bf16) and flash_bwd_dq_kernel_tf32 (f32).
//
// All recover the softmax from the forward's f32 log-sum-exp and compute,
// per (q, k) pair of a tile:
//   P  = exp(scale * q.k - lse)          (0 where the causal/window mask drops)
//   dP = dO.v
//   dS = P * (dP - delta) * scale,  delta = rowsum(dO * O)
// then dV += P^T dO and dK += dS^T Q (kernel 2), dQ += dS K (kernel 3), all
// accumulated in f32.  delta is computed inside each kernel in f32, as the
// TPU kernels do (:333, :392): no pre-pass and no [B*H, T] side buffer.
// bf16 rounding happens exactly where the TPU kernel casts: P is rounded to
// dO's dtype before P^T dO, dS to the input dtype before dS^T Q and dS K
// (in f32 nothing is rounded); lse and delta stay f32.
//
// Grouped-query attention: q head h reads kv head h / (H / G) (group-major,
// as the forward).  Kernel 2 gives one block one KV tile of one KV head and
// loops over the group's q heads and their q tiles, so the group's
// contributions land in one register accumulator: no atomics, and the sum
// order is fixed (deterministic).  This in-block loop is the TPU's
// sequential third grid axis (`group * n_q`, :492).  Kernel 3 gives one
// block one q tile of one q head and loops over the KV tiles.
//
// Causal and window skip are loop bounds.  Kernel 2: the q tiles that reach
// KV tile j start at j*BK/BQ and, with a window, end at
// (window + (j+1)*BK - 2) / BQ -- the clamped index map at :473-480.
// Kernel 3: the forward's j_lo/j_hi (:512-523, sm90::kv_tiles).  The masks
// of :338-344 and :397-406 run only on diagonal, window-edge and ragged
// tiles.
//
// What bounds it on this card.  At the training shape (B=32, H=G=8, T=1024,
// D=64, not causal) kernel 2 does 8*D flops per (q, k) pair (S, dP, dV, dK)
// = 137 GFLOP and kernel 3 does 6*D = 103 GFLOP (S and dP are recomputed
// in both, as on the TPU); their compulsory traffic is 5 [B*H, T, D] inputs
// plus lse and one or two outputs, about 0.47 GB in f32.  On the H100's
// datasheet rates (3.35 TB/s; 989 TFLOP/s bf16 dense on the tensor cores;
// f32 accuracy on the tensor cores as 3xTF32, three TF32 products at 495
// TFLOP/s, 165 TFLOP/s in effect, against 67 TFLOP/s on the FMA units) both
// are bound by operations: 0.14 and 0.10 ms in bf16 (against 0.07 and 0.06
// ms of bytes), 0.83 and 0.62 ms in f32.
//
// What the design does about it.  As in flash_fwd.cu, nothing O(T^2)
// reaches device memory: a block's K and V tiles (kernel 2) or Q and dO
// tiles (kernel 3) stay in shared memory for its life and the other
// operands stream through.  Every product runs on the tensor cores (wgmma),
// each waited on before the registers it writes are touched.  Four kernels:
//
// - bf16 dK/dV: flash_bwd_dkdv_kernel_wgmma.  One warpgroup (128 threads)
//   owns 64 keys of one KV head; its K and V tiles stay in swizzled shared
//   memory and its dK and dV accumulators in registers.  Q, dO, O and lse
//   stream through a 2-stage cp.async ring.  The scores are computed
//   transposed, S^T = K.Q^T and dP^T = V.dO^T (both operands from shared
//   memory), so a thread's accumulator columns are q rows: lse and delta
//   are read per column from a shared vector, and P^T = ex2.approx(S^T *
//   scale * log2(e) - lse * log2(e)).  P^T and dS^T are rounded to bf16 in
//   registers and are the register A operands of dV += P^T.dO and dK +=
//   dS^T.Q, with dO and Q as MN-major B operands of the same stage: P and dS
//   never touch shared memory.  delta is reduced from the stage's dO and O
//   while the score products run.  Shared memory 66 KiB at D=64, 130 KiB
//   at D=128.  Helpers: sm90.cuh.
// - bf16 dQ: flash_bwd_dq_kernel_wgmma.  One warpgroup owns 64 q rows of
//   one q head; its Q and dO tiles stay in swizzled shared memory and its dQ
//   accumulator in registers (f32, stored once as bf16).  K and V stream
//   through a 2-stage cp.async ring.  S = Q.K^T and dP = dO.V^T are issued
//   back to back (both operands K-major from shared memory) and waited on
//   once.  The scores are not transposed here, so a thread's accumulator
//   rows are its q rows: lse and delta are two registers per thread (delta
//   from the 4 threads of each row's quad, read once from device memory).
//   dS is rounded to bf16 in registers and is the register A operand of dQ
//   += dS.K, the stage's K tile serving as the MN-major B operand (N = D).
//   Shared memory 49 KiB at D=64, 97 KiB at D=128.
// - f32 dK/dV and dQ: flash_bwd_dkdv_kernel_tf32 and
//   flash_bwd_dq_kernel_tf32, the two designs above in 3xTF32, as the f32
//   forward (flash_fwd.cu): each operand x is split as hi = tf32(x), lo =
//   tf32(x - hi) (cvt.rna), and each product is hi.lo + lo.hi + hi.hi, about
//   2^-22 of it lost (a single TF32 pass loses 2^-11 and misses the 1e-4
//   gradient agreement).  P, dS, lse and delta stay f32.  What differs from
//   bf16, and what the kernels do about it:
//   * TF32 operands have no transpose bit: both are K-major.  The score
//     products' operands are as stored (kernel 3: Q, dO resident and K, V
//     streamed; kernel 2: K, V resident and Q, dO streamed).  The products
//     that sum over the other axis need their B operand transposed: K^T
//     [D][keys] for dQ += dS.K, Q^T and dO^T [D][q] for dK += dS^T.Q and
//     dV += P^T.dO.  The streamed tiles land raw (cp.async cannot
//     transpose), and a split pass writes their hi/lo tiles as stored and
//     transposed; the resident ones are split once, from device memory.
//   * The TF32 register A fragment is not the accumulator layout: the
//     transposed tiles store each 8-key (kernel 3) or 8-q-row (kernel 2)
//     group in sm90::tf32_key order, so a thread's accumulator entries of
//     dS, P^T and dS^T are their A fragments without a shuffle.
//   * Accumulation order: each k-step rounds the running sum at its size,
//     so the small products go first, and each tile's contribution to dQ,
//     dK or dV goes into a fresh accumulator (64 output columns at a time)
//     that is added to the running f32 sum in registers; the running sums
//     are never rounded inside a wgmma at their full size.
//   * Shared memory bounds the tiles (Tf32 configs below): two warpgroups
//     share each streamed tile, so the split pass is paid once for 128 rows
//     (D = 128: one warpgroup); the split tiles serve as the second stage
//     (the next raw tile lands while one is multiplied).  kernel 3: 32-key
//     tiles at D = 64 (193 KiB), 16-key at D = 128; kernel 2: 32-row q
//     tiles at D = 64 (217 KiB), 16-row at D = 128.  One block per SM.
//     Kernel 2 reduces delta from the raw dO and O tiles in the split pass.
//   * Registers: every tile sits at a fixed address, so the compiler
//     hoisted one descriptor per k-step and tile out of the loop (up to
//     128 registers) and spilled at D = 128; the tile addresses are
//     laundered once per iteration (sm90::opaque), and no instance spills.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;  // q rows per warpgroup
constexpr int BK = 64;  // keys per warpgroup (kernel 2), per bf16 KV tile

__device__ __forceinline__ bool keep_pair(int qp, int kp, int seq, int causal,
                                          int window) {
  bool kk = qp < seq && kp < seq;
  if (causal) {
    kk = kk && qp >= kp;
    if (window > 0) kk = kk && qp - kp < window;
  }
  return kk;
}

// ---- bf16 dK/dV: tensor cores (wgmma) -------------------------------------

constexpr int WG = 128;  // threads: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// K and V tiles (resident), then 2 stages x (Q, dO, O tiles), each
// 1024-byte aligned, then 2 stages x (lse[64], delta[64]) f32.
template <int D>
struct DkdvWgSmem {
  using Tl = sm90::Tile<D, BQ>;
  static constexpr int VEC = 2 * Tl::BYTES + 2 * 3 * Tl::BYTES;
  static constexpr size_t bytes = 1024 + VEC + 2 * 2 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(WG)
    flash_bwd_dkdv_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int H, int G,
                                int seq, float scale, int causal,
                                int window) {
  static_assert(BQ == 64 && BK == 64, "one m64n64 score tile per q tile");
  using Tl = sm90::Tile<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t sK = base, sV = base + Tl::BYTES;
  const uint32_t sStages = base + 2 * Tl::BYTES;  // stage s: Q, dO, O
  float* vec = reinterpret_cast<float*>(gbase + DkdvWgSmem<D>::VEC);

  const int tid = threadIdx.x;
  // Causal: the first KV tiles see the most q tiles; they launch first.
  const int jt = blockIdx.x;
  const int bg = blockIdx.y;  // flat b*G + g
  const int b = bg / G, g = bg % G;
  const int group = H / G;
  const int k0 = jt * BK;

  // The q tiles that reach this KV tile: causal starts at the diagonal, a
  // window ends where the band of the tile's last key runs out.
  const int n_q = (seq + BQ - 1) / BQ;
  int i_lo = 0, i_hi = n_q - 1;
  if (causal) {
    i_lo = k0 / BQ;
    if (window > 0) i_hi = min(i_hi, (window + k0 + BK - 2) / BQ);
  }
  const int n_qt = i_hi - i_lo + 1;
  const int n_iter = group * n_qt;  // the group's q heads x their q tiles

  // Iteration it: q head m = it / n_qt of the group, q tile i_lo + it % n_qt.
  auto load_q = [&](int it) {
    const int st = it & 1;
    const size_t head = (size_t)(b * H + g * group + it / n_qt) * seq;
    const int q0 = (i_lo + it % n_qt) * BQ;
    const uint32_t dst = sStages + st * 3 * Tl::BYTES;
    sm90::load_tile<D, BQ, WG>(dst, q + head * D, q0, seq, tid);
    sm90::load_tile<D, BQ, WG>(dst + Tl::BYTES, dout + head * D, q0, seq,
                               tid);
    sm90::load_tile<D, BQ, WG>(dst + 2 * Tl::BYTES, o + head * D, q0, seq,
                               tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < seq;
      sm90::cp_async4(sm90::smem_addr(vec + st * 2 * BQ + tid),
                      lse + head + (ok ? q0 + tid : 0), ok);
    }
  };
  sm90::load_tile<D, BK, WG>(sK, k + (size_t)bg * seq * D, k0, seq, tid);
  sm90::load_tile<D, BK, WG>(sV, v + (size_t)bg * seq * D, k0, seq, tid);
  load_q(0);
  sm90::cp_async_commit();

  // This thread's accumulator rows (keys) r0 and r0 + 8 and columns
  // 8j + c0 (+1): q rows of S^T and dP^T, head-dim columns of dK and dV.
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  const float sl2 = scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();  // stage it is in; every thread is done with it - 1
    if (it + 1 < n_iter) load_q(it + 1);
    sm90::cp_async_commit();
    const int st = it & 1;
    const uint32_t sQ = sStages + st * 3 * Tl::BYTES;
    const uint32_t sdO = sQ + Tl::BYTES, sO = sdO + Tl::BYTES;
    const float* lse_s = vec + st * 2 * BQ;
    float* delta_s = vec + st * 2 * BQ + BQ;

    // S^T = K Q^T and dP^T = V dO^T (keys x q rows).
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(s, Tl::kmajor(sK, kk), Tl::kmajor(sQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(dp, Tl::kmajor(sV, kk), Tl::kmajor(sdO, kk), kk);
    sm90::wgmma_commit();

    // delta = rowsum(dO * O) in f32 while the products run: two threads
    // per q row, each over half the row, read from the swizzled tiles.
    {
      const int row = tid >> 1, half = tid & 1;
      float part = 0.f;
#pragma unroll
      for (int n = 0; n < Tl::CHUNKS / 2; ++n) {
        const uint32_t off = Tl::chunk(row, half * (Tl::CHUNKS / 2) + n);
        const uint4 gv =
            *reinterpret_cast<const uint4*>(gbase + (sdO - base) + off);
        const uint4 ov =
            *reinterpret_cast<const uint4*>(gbase + (sO - base) + off);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(g2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          part = fmaf(gf.x, of.x, part);
          part = fmaf(gf.y, of.y, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) delta_s[row] = part;
    }
    __syncthreads();  // delta is in
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T = exp(scale S^T - lse) (0 where masked) and
    // dS^T = P^T (dP^T - delta) scale, per column (= q row) statistics.
    const int q0 = (i_lo + it % n_qt) * BQ;
    const bool edge =
        q0 + BQ > seq || k0 + BK > seq ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
      const float2 del2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + c0);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lse_c = (c ? lse2.y : lse2.x) * LOG2E;
        const float del_c = c ? del2.y : del2.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + c;
          float p = sm90::exp2_approx(fmaf(s[idx], sl2, -lse_c));
          if (edge &&
              !keep_pair(q0 + 8 * j + c0 + c, k0 + r0 + 8 * i, seq, causal,
                         window))
            p = 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - del_c) * scale;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: P^T (rounded to dO's dtype) and dS^T
    // (rounded to the input dtype) are the register A operands; dO and Q
    // are MN-major B operands from the stage.
    uint32_t pa[16], da[16];
    sm90::pack_a<32>(pa, s);
    sm90::pack_a<32>(da, dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::wgmma_rs<D>(acc_v, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                        pa[4 * kk + 3], Tl::mnmajor(sdO, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      sm90::wgmma_rs<D>(acc_k, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                        da[4 * kk + 3], Tl::mnmajor(sQ, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_v);
    sm90::fence_regs(acc_k);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + r0 + 8 * i;
    if (kp >= seq) continue;
    const size_t row = ((size_t)bg * seq + kp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int idx = 4 * j + 2 * i;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + c0) =
          __floats2bfloat162_rn(acc_k[idx], acc_k[idx + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + c0) =
          __floats2bfloat162_rn(acc_v[idx], acc_v[idx + 1]);
    }
  }
}

// ---- bf16 dQ: tensor cores (wgmma) ----------------------------------------

// Q and dO tiles (resident), then 2 stages x (K, V tiles), each 1024-byte
// aligned.
template <int D>
struct DqWgSmem {
  using Tl = sm90::Tile<D, BQ>;
  static constexpr size_t bytes = 1024 + Tl::BYTES * (2 + 2 * 2);
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_bwd_dq_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              __nv_bfloat16* __restrict__ dq, int H, int G,
                              int seq, float scale, int causal, int window) {
  static_assert(BQ == 64 && BK == 64, "one m64n64 score tile per KV tile");
  using Tl = sm90::Tile<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + Tl::BYTES;
  const uint32_t sKV = sdO + Tl::BYTES;  // stage s: K at +2s tiles, V after

  const int tid = threadIdx.x;
  // Causal: the last q tiles see the most keys; they launch first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQ;
  const size_t head = (size_t)bh * seq;
  const __nv_bfloat16* kb = k + (size_t)kvh * seq * D;
  const __nv_bfloat16* vb = v + (size_t)kvh * seq * D;

  // The forward's KV range for this q tile.
  int j_lo;
  const int n_kv = sm90::kv_tiles(q0, BQ, BK, seq, causal, window, j_lo);

  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t & 1) * 2 * Tl::BYTES;
    const int k0 = (j_lo + t) * BK;
    sm90::load_tile<D, BK, WG>(dst, kb, k0, seq, tid);
    sm90::load_tile<D, BK, WG>(dst + Tl::BYTES, vb, k0, seq, tid);
  };
  // Q, dO and KV tile 0 in one commit group; tile t is group t.
  sm90::load_tile<D, BQ, WG>(sQ, q + head * D, q0, seq, tid);
  sm90::load_tile<D, BQ, WG>(sdO, dout + head * D, q0, seq, tid);
  load_kv(0);
  sm90::cp_async_commit();

  // This thread's accumulator rows r0 and r0 + 8, columns 8j + c0 (+1).
  // Their lse (log2 units) and delta = rowsum(dO * O) in f32, each row's
  // delta from the 4 threads of its quad, D/4 columns each, read once from
  // device memory while the tiles land.
  const int r0 = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c0 = 2 * (tid & 3);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    float part = 0.f;
    if (qp < seq) {
      const size_t off = (head + qp) * D + (tid & 3) * (D / 4);
      const __nv_bfloat162* g2 =
          reinterpret_cast<const __nv_bfloat162*>(dout + off);
      const __nv_bfloat162* o2 =
          reinterpret_cast<const __nv_bfloat162*>(o + off);
#pragma unroll
      for (int e = 0; e < D / 8; ++e) {
        const float2 gf = __bfloat1622float2(g2[e]);
        const float2 of = __bfloat1622float2(o2[e]);
        part = fmaf(gf.x, of.x, part);
        part = fmaf(gf.y, of.y, part);
      }
    }
    delta[i] = quad_sum(part);
    lse2[i] = qp < seq ? lse[head + qp] * LOG2E : 0.f;
  }

  const float sl2 = scale * LOG2E;
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1,
                      // whose stage now takes tile t + 1
    if (t + 1 < n_kv) load_kv(t + 1);
    sm90::cp_async_commit();
    const uint32_t sK = sKV + (t & 1) * 2 * Tl::BYTES;
    const uint32_t sV = sK + Tl::BYTES;

    // S = Q K^T and dP = dO V^T, issued back to back.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(s, Tl::kmajor(sQ, kk), Tl::kmajor(sK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_ss_n64(dp, Tl::kmajor(sdO, kk), Tl::kmajor(sV, kk), kk);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P = exp(scale S - lse) (0 where masked; the mask only on diagonal,
    // window-edge and ragged tiles) and dS = P (dP - delta) scale.
    const int k0 = (j_lo + t) * BK;
    const bool edge =
        q0 + BQ > seq || k0 + BK > seq ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * i + c;
          float p = sm90::exp2_approx(fmaf(s[idx], sl2, -lse2[i]));
          if (edge && !keep_pair(q0 + r0 + 8 * i, k0 + 8 * j + c0 + c, seq,
                                 causal, window))
            p = 0.f;
          s[idx] = p * (dp[idx] - delta[i]) * scale;
        }

    // dQ += dS K: dS (rounded to bf16, as the TPU kernel casts it) is the
    // register A operand, K the MN-major B operand (N = D) of the stage.
    uint32_t da[16];
    sm90::pack_a<32>(da, s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_rs<D>(acc, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                        da[4 * kk + 3], Tl::mnmajor(sK, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= seq) continue;
    __nv_bfloat16* row = dq + (head + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// ---- f32: tensor cores, 3xTF32 (wgmma) -------------------------------------

// acc[D/2] += X.B for one streamed tile: X is an m64 accumulator of KS
// 8-column k-steps (f32, in registers), split here into its hi and lo TF32
// A fragments (k-step j: (x[4j], x[4j+2], x[4j+1], x[4j+3]), see sm90.cuh);
// B is a K-major [D][8*KS] tile BT (hi at bh, lo at bl) whose k index is
// stored in tf32_key order.  The products go small first (Xhi.Blo,
// Xlo.Bhi, Xhi.Bhi) into a fresh accumulator of NC output columns at a
// time (rows NC*h.. of B), which is then added to acc in f32.
template <int D, int KS, typename BT>
__device__ __forceinline__ void add_product_tf32(float (&acc)[D / 2],
                                                 const float (&x)[4 * KS],
                                                 uint32_t bh, uint32_t bl) {
  constexpr int NC = D < 64 ? D : 64;
  uint32_t xh[4 * KS], xl[4 * KS];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sm90::split_tf32(x[4 * j + 2 * i + c], xh[4 * j + 2 * c + i],
                         xl[4 * j + 2 * c + i]);
  float tile[NC / 2];
#pragma unroll
  for (int n = 0; n < NC / 2; ++n) tile[n] = 0.f;
#pragma unroll
  for (int h = 0; h < D / NC; ++h) {
    const uint32_t hh = bh + NC * h * BT::RB, hl = bl + NC * h * BT::RB;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS; ++j)
      sm90::wgmma_rs_tf32<NC>(tile, xh[4 * j], xh[4 * j + 1], xh[4 * j + 2],
                              xh[4 * j + 3], BT::kmajor(hl, j), j);
#pragma unroll
    for (int j = 0; j < KS; ++j)
      sm90::wgmma_rs_tf32<NC>(tile, xl[4 * j], xl[4 * j + 1], xl[4 * j + 2],
                              xl[4 * j + 3], BT::kmajor(hh, j), 1);
#pragma unroll
    for (int j = 0; j < KS; ++j)
      sm90::wgmma_rs_tf32<NC>(tile, xh[4 * j], xh[4 * j + 1], xh[4 * j + 2],
                              xh[4 * j + 3], BT::kmajor(hh, j), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(tile);
#pragma unroll
    for (int n = 0; n < NC / 2; ++n) acc[NC / 2 * h + n] += tile[n];
  }
}

// The split pass of one raw [ROWS][D] f32 tile in shared memory (row-major,
// 16-byte chunk i at 16*i): as stored into the hi/lo tiles at sh/sl
// (Tile<D, ROWS, 4>, K-major over D) and transposed into the hi/lo tiles at
// th/tl (Tile<ROWS, D, 4>: [D][ROWS], K-major over the rows, each 8-row
// group in tf32_key order), spread over NT threads.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void split_both(uint8_t* gbase, uint32_t base,
                                           const float* src, uint32_t sh,
                                           uint32_t sl, uint32_t th,
                                           uint32_t tl, int tid) {
  using ST = sm90::Tile<D, ROWS, 4>;
  using TT = sm90::Tile<ROWS, D, 4>;
  constexpr int CH = D / 4;  // 16-byte chunks of an f32 row
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = tid + n * NT;
    uint4 hi, lo;
    sm90::split_tf32x4(reinterpret_cast<const float4*>(src)[i], hi, lo);
    const uint32_t off = ST::chunk(i / CH, i % CH);
    *reinterpret_cast<uint4*>(gbase + (sh - base) + off) = hi;
    *reinterpret_cast<uint4*>(gbase + (sl - base) + off) = lo;
  }
  // Row col of the transposed tile, chunk c: 4 source rows of column col.
#pragma unroll
  for (int n = 0; n < ROWS * CH / NT; ++n) {
    const int i = tid + n * NT;
    const int col = i % D, c = i / D;
    const int row0 = 8 * (c / 2);
    float4 x;
    x.x = src[(row0 + sm90::tf32_key(4 * (c % 2) + 0)) * D + col];
    x.y = src[(row0 + sm90::tf32_key(4 * (c % 2) + 1)) * D + col];
    x.z = src[(row0 + sm90::tf32_key(4 * (c % 2) + 2)) * D + col];
    x.w = src[(row0 + sm90::tf32_key(4 * (c % 2) + 3)) * D + col];
    uint4 hi, lo;
    sm90::split_tf32x4(x, hi, lo);
    const uint32_t off = TT::chunk(col, c);
    *reinterpret_cast<uint4*>(gbase + (th - base) + off) = hi;
    *reinterpret_cast<uint4*>(gbase + (tl - base) + off) = lo;
  }
}

// f32 dQ by head dim: NWG warpgroups of 64 q rows share each KV tile of BKT
// keys.  Shared memory: Q and dO hi/lo per warpgroup (resident), K and V
// hi/lo ([keys][D]), K^T hi/lo ([D][keys]) and the raw K and V tiles the
// next copy lands in: 193 KiB at D = 64 (two warpgroups, 32-key tiles; 64
// keys would need 257 KiB) and at D = 128 (one warpgroup, 16-key tiles).
template <int D>
struct DqTf32Cfg {
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int BKT = D == 128 ? 16 : D == 64 ? 32 : 64;
  static constexpr int NT = NWG * WG;
  using QT = sm90::Tile<D, BQ, 4>;    // a warpgroup's Q or dO, hi or lo
  using KT = sm90::Tile<D, BKT, 4>;   // K or V, hi or lo: B of S and dP
  using KTT = sm90::Tile<BKT, D, 4>;  // K^T, hi or lo: B of dS.K
  static constexpr int RAW = BKT * D * 4;  // a raw K or V tile, row-major
  static constexpr size_t bytes = 1024 + 4 * NWG * QT::BYTES +
                                  4 * KT::BYTES + 2 * KTT::BYTES + 2 * RAW;
  static_assert(bytes <= 232448, "a block holds at most 227 KiB");
};

template <int D>
__global__ void __launch_bounds__(DqTf32Cfg<D>::NT)
    flash_bwd_dq_kernel_tf32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dq, int H, int G, int seq,
                             float scale, int causal, int window) {
  using C = DqTf32Cfg<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  using KTT = typename C::KTT;
  constexpr int BKT = C::BKT, NT = C::NT, BQB = BQ * C::NWG;
  constexpr int CH = D / 4;  // 16-byte chunks of an f32 row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t sQ = base;  // warpgroup w: Q hi, lo, dO hi, lo at +4w tiles
  const uint32_t sK = sQ + 4 * C::NWG * QT::BYTES;  // K hi, lo, V hi, lo
  const uint32_t sKt = sK + 4 * KT::BYTES;          // K^T hi, lo
  const uint32_t sRaw = sKt + 2 * KTT::BYTES;       // raw K, raw V

  const int tid = threadIdx.x;
  const int wg = tid / WG, wt = tid % WG;
  // Heaviest causal tiles first (the last q tiles see the most keys).
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQB;       // the block's first q row
  const int q0w = q0 + BQ * wg;  // this warpgroup's
  const size_t head = (size_t)bh * seq;
  const float* kb = k + (size_t)kvh * seq * D;
  const float* vb = v + (size_t)kvh * seq * D;

  // The forward's KV range for the block's q rows.
  int j_lo;
  const int n_kv = sm90::kv_tiles(q0, BQB, BKT, seq, causal, window, j_lo);

  // Raw K and V tile t, row-major, rows past seq zeroed.
  auto load_kv = [&](int t) {
    const int k0 = (j_lo + t) * BKT;
    sm90::load_rows_f32<D, BKT, NT>(sRaw, kb, k0, seq, tid);
    sm90::load_rows_f32<D, BKT, NT>(sRaw + C::RAW, vb, k0, seq, tid);
  };
  load_kv(0);
  sm90::cp_async_commit();

  // Q and dO, read once from device memory, split into each warpgroup's hi
  // and lo tiles while KV tile 0 lands.
  sm90::split_rows<D, BQB, NT>(gbase, base, sQ, 4 * QT::BYTES, q + head * D,
                               q0, seq, tid);
  sm90::split_rows<D, BQB, NT>(gbase, base, sQ + 2 * QT::BYTES,
                               4 * QT::BYTES, dout + head * D, q0, seq, tid);

  // This thread's accumulator rows r0 and r0 + 8 (of its warpgroup's 64),
  // columns 8j + c0 (+1); their lse (log2 units) and delta = rowsum(dO * O)
  // in f32, each row's delta from the 4 threads of its quad, D/4 columns
  // each, read from device memory.
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2);
  const int c0 = 2 * (wt & 3);
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0w + r0 + 8 * i;
    float part = 0.f;
    if (qp < seq) {
      const size_t off = (head + qp) * D + (wt & 3) * (D / 4);
      const float4* g4 = reinterpret_cast<const float4*>(dout + off);
      const float4* o4 = reinterpret_cast<const float4*>(o + off);
#pragma unroll
      for (int e = 0; e < D / 16; ++e) {
        const float4 gv = g4[e], ov = o4[e];
        part = fmaf(gv.x, ov.x, part);
        part = fmaf(gv.y, ov.y, part);
        part = fmaf(gv.z, ov.z, part);
        part = fmaf(gv.w, ov.w, part);
      }
    }
    delta[i] = quad_sum(part);
    lse2[i] = qp < seq ? lse[head + qp] * LOG2E : 0.f;
  }

  const float sl2 = scale * LOG2E;
  float acc[D / 2], s[BKT / 2], dp[BKT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) s[i] = dp[i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // raw tile t is in; both warpgroups are done with the
                      // split tiles of t - 1
    // This iteration's tile addresses (see sm90::opaque).
    const uint32_t sQh = sm90::opaque(sQ + wg * 4 * QT::BYTES);
    const uint32_t sQl = sQh + QT::BYTES, sGh = sQl + QT::BYTES;
    const uint32_t sGl = sGh + QT::BYTES;
    const uint32_t sKh = sm90::opaque(sK), sKl = sKh + KT::BYTES;
    const uint32_t sVh = sKl + KT::BYTES, sVl = sVh + KT::BYTES;
    const uint32_t sKth = sVl + KT::BYTES, sKtl = sKth + KTT::BYTES;
    // The split pass: K as stored and transposed (K^T, keys in tf32_key
    // order), V as stored.
    {
      const float* rk = reinterpret_cast<const float*>(gbase + (sRaw - base));
      const float* rv = rk + C::RAW / 4;
      split_both<D, BKT, NT>(gbase, base, rk, sKh, sKl, sKth, sKtl, tid);
#pragma unroll
      for (int n = 0; n < BKT * CH / NT; ++n) {
        const int i = tid + n * NT;
        uint4 hi, lo;
        sm90::split_tf32x4(reinterpret_cast<const float4*>(rv)[i], hi, lo);
        const uint32_t off = KT::chunk(i / CH, i % CH);
        *reinterpret_cast<uint4*>(gbase + (sVh - base) + off) = hi;
        *reinterpret_cast<uint4*>(gbase + (sVl - base) + off) = lo;
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
        q0w < seq &&
        !(causal && (k0 > q0w + BQ - 1 ||
                     (window > 0 && q0w - (k0 + BKT - 1) >= window)));
    if (!live) continue;

    // S = Q.K^T and dP = dO.V^T, each as hi.lo + lo.hi + hi.hi (small
    // first), issued back to back and waited on once.
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
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(dp, QT::kmajor(sGh, kk), KT::kmajor(sVl, kk),
                               kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(dp, QT::kmajor(sGl, kk), KT::kmajor(sVh, kk),
                               1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BKT>(dp, QT::kmajor(sGh, kk), KT::kmajor(sVh, kk),
                               1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P = exp(scale S - lse) (0 where masked; the mask only on diagonal,
    // window-edge and ragged tiles) and dS = P (dP - delta) scale, in f32.
    const bool edge =
        q0w + BQ > seq || k0 + BKT > seq ||
        (causal && (k0 + BKT - 1 > q0w ||
                    (window > 0 && q0w + BQ - 1 - k0 >= window)));
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * i + c;
          float p = sm90::exp2_approx(fmaf(s[idx], sl2, -lse2[i]));
          if (edge && !keep_pair(q0w + r0 + 8 * i, k0 + 8 * j + c0 + c, seq,
                                 causal, window))
            p = 0.f;
          s[idx] = p * (dp[idx] - delta[i]) * scale;
        }

    // dQ += dS.K: dS the register A operand, K^T the K-major B operand.
    add_product_tf32<D, BKT / 8, KTT>(acc, s, sKth, sKtl);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0w + r0 + 8 * i;
    if (qp >= seq) continue;
    float* row = dq + (head + qp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// f32 dK/dV by head dim: NWG warpgroups of 64 keys share each q tile of BQT
// rows.  Shared memory: K and V hi/lo per warpgroup (resident), Q and dO
// hi/lo ([q][D]), Q^T and dO^T hi/lo ([D][q]), the raw Q, dO and O tiles
// the next copy lands in, and three vectors of BQT floats (the raw lse, and
// the split pass's lse in log2 units and delta): 217 KiB at D = 64 (two
// warpgroups, 32-row q tiles; 64 rows would need 265 KiB) and at D = 128
// (one warpgroup, 16-row q tiles).
template <int D>
struct DkdvTf32Cfg {
  static constexpr int NWG = D == 128 ? 1 : 2;
  static constexpr int BQT = D == 128 ? 16 : D == 64 ? 32 : 64;
  static constexpr int NT = NWG * WG;
  static constexpr int BKB = BK * NWG;  // keys per block
  using KT = sm90::Tile<D, BK, 4>;      // a warpgroup's K or V, hi or lo
  using QT = sm90::Tile<D, BQT, 4>;     // Q or dO, hi or lo: B of S^T, dP^T
  using QTT = sm90::Tile<BQT, D, 4>;    // Q^T or dO^T: B of dS^T.Q, P^T.dO
  static constexpr int RAW = BQT * D * 4;  // a raw Q, dO or O tile
  static constexpr int VEC = 4 * NWG * KT::BYTES + 4 * QT::BYTES +
                             4 * QTT::BYTES + 3 * RAW;
  static constexpr size_t bytes = 1024 + VEC + 3 * BQT * sizeof(float);
  static_assert(bytes <= 232448, "a block holds at most 227 KiB");
};

template <int D>
__global__ void __launch_bounds__(DkdvTf32Cfg<D>::NT)
    flash_bwd_dkdv_kernel_tf32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ o,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int H, int G, int seq, float scale, int causal,
                               int window) {
  using C = DkdvTf32Cfg<D>;
  using KT = typename C::KT;
  using QT = typename C::QT;
  using QTT = typename C::QTT;
  constexpr int BQT = C::BQT, NT = C::NT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);  // base as a generic pointer
  const uint32_t sK = base;  // warpgroup w: K hi, lo, V hi, lo at +4w tiles
  const uint32_t sQ = sK + 4 * C::NWG * KT::BYTES;  // Q hi, lo, dO hi, lo
  const uint32_t sQt = sQ + 4 * QT::BYTES;     // Q^T hi, lo, dO^T hi, lo
  const uint32_t sRaw = sQt + 4 * QTT::BYTES;  // raw Q, dO, O
  float* lse_raw = reinterpret_cast<float*>(gbase + C::VEC);
  float* lse_s = lse_raw + BQT;  // log2 units, for the products
  float* delta_s = lse_s + BQT;

  const int tid = threadIdx.x;
  const int wg = tid / WG, wt = tid % WG;
  // Causal: the first KV tiles see the most q tiles; they launch first.
  const int bg = blockIdx.y;  // flat b*G + g
  const int b = bg / G, g = bg % G;
  const int group = H / G;
  const int k0 = blockIdx.x * C::BKB;  // the block's first key
  const int kw0 = k0 + BK * wg;        // this warpgroup's

  // The q tiles that reach the block's keys (as the bf16 kernel, with BQT
  // rows and BKB keys).
  const int n_q = (seq + BQT - 1) / BQT;
  int i_lo = 0, i_hi = n_q - 1;
  if (causal) {
    i_lo = k0 / BQT;
    if (window > 0) i_hi = min(i_hi, (window + k0 + C::BKB - 2) / BQT);
  }
  const int n_qt = i_hi - i_lo + 1;
  const int n_iter = group * n_qt;  // the group's q heads x their q tiles

  // Raw Q, dO, O and lse of iteration it: q head m = it / n_qt of the
  // group, q tile i_lo + it % n_qt; rows past seq zeroed.
  auto load_q = [&](int it) {
    const size_t head = (size_t)(b * H + g * group + it / n_qt) * seq;
    const int q0 = (i_lo + it % n_qt) * BQT;
    sm90::load_rows_f32<D, BQT, NT>(sRaw, q + head * D, q0, seq, tid);
    sm90::load_rows_f32<D, BQT, NT>(sRaw + C::RAW, dout + head * D, q0, seq,
                                    tid);
    sm90::load_rows_f32<D, BQT, NT>(sRaw + 2 * C::RAW, o + head * D, q0, seq,
                                    tid);
    if (tid < BQT) {
      const bool ok = q0 + tid < seq;
      sm90::cp_async4(sm90::smem_addr(lse_raw + tid),
                      lse + head + (ok ? q0 + tid : 0), ok);
    }
  };
  load_q(0);
  sm90::cp_async_commit();

  // K and V, read once from device memory, split into each warpgroup's hi
  // and lo tiles while the first q tile lands.
  sm90::split_rows<D, C::BKB, NT>(gbase, base, sK, 4 * KT::BYTES,
                                 k + (size_t)bg * seq * D, k0, seq, tid);
  sm90::split_rows<D, C::BKB, NT>(gbase, base, sK + 2 * KT::BYTES,
                                  4 * KT::BYTES, v + (size_t)bg * seq * D, k0,
                                  seq, tid);

  // This thread's accumulator rows (keys) r0 and r0 + 8 and columns 8j + c0
  // (+1): q rows of S^T and dP^T, head-dim columns of dK and dV.
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2);
  const int c0 = 2 * (wt & 3);
  const float sl2 = scale * LOG2E;
  float acc_k[D / 2], acc_v[D / 2], s[BQT / 2], dp[BQT / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQT / 2; ++i) s[i] = dp[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    sm90::cp_async_wait<0>();
    __syncthreads();  // raw tile it is in; both warpgroups are done with the
                      // split tiles and vectors of it - 1
    // This iteration's tile addresses (see sm90::opaque).
    const uint32_t sKh = sm90::opaque(sK + wg * 4 * KT::BYTES);
    const uint32_t sKl = sKh + KT::BYTES, sVh = sKl + KT::BYTES;
    const uint32_t sVl = sVh + KT::BYTES;
    const uint32_t sQh = sm90::opaque(sQ), sQl = sQh + QT::BYTES;
    const uint32_t sGh = sQl + QT::BYTES, sGl = sGh + QT::BYTES;
    const uint32_t sQth = sGl + QT::BYTES, sQtl = sQth + QTT::BYTES;
    const uint32_t sGth = sQtl + QTT::BYTES, sGtl = sGth + QTT::BYTES;
    // The split pass: Q and dO as stored and transposed (q rows in
    // tf32_key order); then, TPR threads a q row, its lse in log2 units and
    // delta = rowsum(dO * O) in f32.
    {
      const float* rq = reinterpret_cast<const float*>(gbase + (sRaw - base));
      const float* rg = rq + C::RAW / 4;
      const float* ro = rg + C::RAW / 4;
      split_both<D, BQT, NT>(gbase, base, rq, sQh, sQl, sQth, sQtl, tid);
      split_both<D, BQT, NT>(gbase, base, rg, sGh, sGl, sGth, sGtl, tid);
      constexpr int TPR = NT / BQT;
      static_assert(TPR <= 32 && D % (4 * TPR) == 0, "whole float4s");
      const int row = tid / TPR, col0 = (tid % TPR) * (D / TPR);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < D / TPR; e += 4) {
        const float4 gv =
            *reinterpret_cast<const float4*>(rg + row * D + col0 + e);
        const float4 ov =
            *reinterpret_cast<const float4*>(ro + row * D + col0 + e);
        part = fmaf(gv.x, ov.x, part);
        part = fmaf(gv.y, ov.y, part);
        part = fmaf(gv.z, ov.z, part);
        part = fmaf(gv.w, ov.w, part);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (tid % TPR == 0) {
        delta_s[row] = part;
        lse_s[row] = lse_raw[row] * LOG2E;
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();  // the split tiles and vectors are in; raw is free
    if (it + 1 < n_iter) load_q(it + 1);
    sm90::cp_async_commit();

    // Skip a q tile none of this warpgroup's keys sees (causal: below its
    // diagonal or past its window; ragged: no key left).
    const int q0 = (i_lo + it % n_qt) * BQT;
    const bool live =
        kw0 < seq &&
        !(causal && (q0 + BQT - 1 < kw0 ||
                     (window > 0 && q0 - (kw0 + BK - 1) >= window)));
    if (!live) continue;

    // S^T = K.Q^T and dP^T = V.dO^T (keys x q rows), each as hi.lo + lo.hi
    // + hi.hi (small first), issued back to back and waited on once.
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(s, KT::kmajor(sKh, kk), QT::kmajor(sQl, kk),
                               kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(s, KT::kmajor(sKl, kk), QT::kmajor(sQh, kk),
                               1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(s, KT::kmajor(sKh, kk), QT::kmajor(sQh, kk),
                               1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(dp, KT::kmajor(sVh, kk), QT::kmajor(sGl, kk),
                               kk);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(dp, KT::kmajor(sVl, kk), QT::kmajor(sGh, kk),
                               1);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      sm90::wgmma_ss_tf32<BQT>(dp, KT::kmajor(sVh, kk), QT::kmajor(sGh, kk),
                               1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // P^T = exp(scale S^T - lse) (0 where masked) and dS^T = P^T (dP^T -
    // delta) scale, per column (= q row) statistics, in f32.
    const bool edge =
        q0 + BQT > seq || kw0 + BK > seq ||
        (causal && (kw0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQT - 1 - kw0 >= window)));
#pragma unroll
    for (int j = 0; j < BQT / 8; ++j) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(lse_s + 8 * j + c0);
      const float2 del2 =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + c0);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lse_c = c ? lse2.y : lse2.x;
        const float del_c = c ? del2.y : del2.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + c;
          float p = sm90::exp2_approx(fmaf(s[idx], sl2, -lse_c));
          if (edge &&
              !keep_pair(q0 + 8 * j + c0 + c, kw0 + r0 + 8 * i, seq, causal,
                         window))
            p = 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - del_c) * scale;
        }
      }
    }

    // dV += P^T.dO and dK += dS^T.Q: P^T and dS^T the register A operands,
    // dO^T and Q^T the K-major B operands.
    add_product_tf32<D, BQT / 8, QTT>(acc_v, s, sGth, sGtl);
    add_product_tf32<D, BQT / 8, QTT>(acc_k, dp, sQth, sQtl);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kw0 + r0 + 8 * i;
    if (kp >= seq) continue;
    const size_t row = ((size_t)bg * seq + kp) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int idx = 4 * j + 2 * i;
      *reinterpret_cast<float2*>(dk + row + 8 * j + c0) =
          make_float2(acc_k[idx], acc_k[idx + 1]);
      *reinterpret_cast<float2*>(dv + row + 8 * j + c0) =
          make_float2(acc_v[idx], acc_v[idx + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv;
  int B, H, G, seq;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dkdv_wgmma(const Args& a) {
  using bf16 = __nv_bfloat16;
  auto kern = flash_bwd_dkdv_kernel_wgmma<D>;
  const size_t smem = DkdvWgSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + BK - 1) / BK, a.B * a.G);
  kern<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.G, a.seq,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  using bf16 = __nv_bfloat16;
  auto kern = flash_bwd_dq_kernel_wgmma<D>;
  const size_t smem = DqWgSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<bf16*>(a.dq), a.H, a.G, a.seq, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_tf32(const Args& a) {
  using C = DkdvTf32Cfg<D>;
  auto kern = flash_bwd_dkdv_kernel_tf32<D>;
  const size_t smem = C::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + C::BKB - 1) / C::BKB, a.B * a.G);
  kern<<<grid, C::NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.G, a.seq,
      a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tf32(const Args& a) {
  using C = DqTf32Cfg<D>;
  auto kern = flash_bwd_dq_kernel_tf32<D>;
  const size_t smem = C::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + BQ * C::NWG - 1) / (BQ * C::NWG), a.B * a.H);
  kern<<<grid, C::NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dq), a.H, a.G, a.seq, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

// f32 -> flash_bwd_dkdv_kernel_tf32, flash_bwd_dq_kernel_tf32; bf16 ->
// flash_bwd_dkdv_kernel_wgmma, flash_bwd_dq_kernel_wgmma.
template <bool DKDV, bool BF16>
cudaError_t dispatch_dim(const Args& a, int D) {
#define DCT_BWD_CASE(DIM)                                                \
  case DIM:                                                              \
    if constexpr (DKDV && BF16) return launch_dkdv_wgmma<DIM>(a);        \
    else if constexpr (DKDV) return launch_dkdv_tf32<DIM>(a);            \
    else if constexpr (BF16) return launch_dq_wgmma<DIM>(a);             \
    else return launch_dq_tf32<DIM>(a);
  switch (D) {
    DCT_BWD_CASE(16)
    DCT_BWD_CASE(32)
    DCT_BWD_CASE(64)
    DCT_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DCT_BWD_CASE
}

template <bool DKDV>
int run(const Args& a, int D, int dtype) {
  const int rows = DKDV ? a.B * a.G : a.B * a.H;
  if (a.B <= 0 || a.H <= 0 || a.G <= 0 || a.seq <= 0 || a.H % a.G != 0 ||
      rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_dim<DKDV, false>(a, D);
  if (dtype == 1) return (int)dispatch_dim<DKDV, true>(a, D);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout [B,H,T,D]; k, v [B,G,T,D]; all contiguous, of one dtype
// (0 = f32, 1 = bf16); lse [B,H,T] f32 from the forward.  window <= 0 means
// none.  Kernel 2 writes dk, dv [B,G,T,D]; kernel 3 writes dq [B,H,T,D].
extern "C" int dct_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* dk, void* dv, int B,
                                  int H, int G, int seq, int D, float scale,
                                  int causal, int window, int dtype,
                                  void* stream) {
  const Args a{q,  k,  v, o,   dout,  lse,    nullptr, dk,
               dv, B,  H, G,   seq,   scale,  causal,  window,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, D, dtype);
}

extern "C" int dct_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, int B, int H,
                                int G, int seq, int D, float scale,
                                int causal, int window, int dtype,
                                void* stream) {
  const Args a{q,       k,       v, o,   dout,  lse,    dq,     nullptr,
               nullptr, B,       H, G,   seq,   scale,  causal, window,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, D, dtype);
}
