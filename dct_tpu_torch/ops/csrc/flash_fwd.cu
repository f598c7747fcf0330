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
// - the optional per-row log-sum-exp lse = m + log(l), f32;
// - f32 or bf16 inputs, f32 accumulation; P is rounded to the input dtype
//   before P.V exactly where the TPU kernel casts it (`:140-143`), and the
//   scale is applied after q k^T.
//
// What bounds it on this card.  At the serving shape (B=32, H=G=8, T=1024,
// D=64) the work is 4*B*H*T^2*D = 68.7 GFLOP (about half with causal) and the
// compulsory traffic is (2*B*H*T + 2*B*G*T)*D*itemsize = 268 MB in f32,
// 134 MB in bf16.  Against the H100 datasheet (3.35 TB/s; 67 TFLOP/s f32
// without tensor cores; 989 TFLOP/s bf16 dense on tensor cores) the f32 case
// is bound by operations (1.03 ms vs 0.08 ms of bytes) and the bf16 case sits
// near the ridge (0.07 ms of operations vs 0.04 ms of bytes).
//
// What the design does about it.  The score matrix never reaches device
// memory: one thread block owns a 64-row q tile and walks the KV tiles in a
// loop -- the loop replaces the TPU's sequential third grid axis, and the
// causal/window tile skip becomes the loop's bounds (replacing the clamped
// index maps at :218-235).  Blocks run q-tile-major so the q tiles of one
// head share its K/V in L2.  Two kernels, picked by dtype:
//
// - bf16: flash_fwd_kernel_wgmma, on the tensor cores.  One warpgroup (128
//   threads) owns the 64 q rows.  The Q tile is copied once into swizzled
//   shared memory; K/V tiles come through a 2-stage ring of cp.async copies,
//   so the next tile loads while one is multiplied (shallow, so that more
//   blocks fit an SM and overlap one another's softmax and products).
//   S = Q.K^T is a wgmma with both operands from shared memory (both
//   K-major), waited on before the softmax: a wgmma still in flight across
//   the softmax made ptxas serialize every wgmma of the kernel.  The online
//   softmax runs on the accumulator fragment (a row lives in the 4 threads
//   of a quad: the row max is two shuffles, the row sum is reduced once at
//   the end; each exponential is one ex2.approx on the SFU, as the
//   softmax's instructions bound the kernel as much as the products do);
//   P is rounded to bf16 in registers and is the register A
//   operand of O += P.V, with V ([keys][D] row-major) the MN-major B operand.
//   The element mask runs only on diagonal, window-edge and ragged tiles.
//   Helpers: sm90.cuh.
// - f32: flash_fwd_kernel, on the FMA units in full f32 (no TF32: TF32 would
//   break the 1e-5 agreement with the reference).  Each of the 256 threads
//   holds a 4x4 block of scores and a 4 x D/16 block of the output
//   accumulator in registers, with the row statistics (m, l) replicated in
//   the 16 threads of a row group, so the per-row rescale needs no shared
//   memory.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NT = 256;        // threads: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;   // q rows per thread
constexpr int CPT = BK / 16;   // score columns per thread
constexpr float NEG = -1e30f;  // finite "minus infinity", the TPU kernel's _NEG

// flash_fwd_kernel is instantiated for f32 only (bf16 takes the tensor-core
// kernel); these are its conversions.
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Shared-memory row strides.  Q and P rows are padded by 4 floats so the two
// row groups of a warp (rows 4 apart) fall in opposite halves of the banks;
// the transposed K tile is padded by 1 so its transposing stores spread.
template <int D>
struct Smem {
  static constexpr int QS = D + 4;
  static constexpr int KS = BK + 1;
  static constexpr int PS = BK + 4;
  static constexpr int floats = BQ * QS + D * KS + BK * D + BQ * PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int G, int seq,
                     float scale, int causal, int window) {
  using S = Smem<D>;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QS]
  float* Kt = Qs + BQ * S::QS;   // [D][KS], the K tile transposed
  float* Vs = Kt + D * S::KS;    // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: tile rows ty*RPT .. ty*RPT+RPT-1
  const int tx = tid & 15;  // column lane: columns tx + 16*j
  // Heaviest causal tiles first (the last q tiles see the most keys).
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQ;

  const T* qb = q + (size_t)bh * seq * D;
  const T* kb = k + (size_t)kvh * seq * D;
  const T* vb = v + (size_t)kvh * seq * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[r * S::QS + d] =
        q0 + r < seq ? to_float(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float acc[RPT][DPT];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // The KV tiles this q tile needs: causal stops at the diagonal, a window
  // starts at the tile holding the first key of the band of row q0.
  const int q_last = min(q0 + BQ, seq) - 1;
  int j_lo = 0, j_hi = (seq + BK - 1) / BK - 1;
  if (causal) {
    j_hi = q_last / BK;
    if (window > 0) j_lo = max(0, q0 - window + 1) / BK;
  }

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile's readers of Kt, Vs, Ps are done
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const bool ok = k0 + c < seq;
      const size_t g = (size_t)(k0 + c) * D + d;
      Kt[d * S::KS + c] = ok ? to_float(kb[g]) : 0.f;
      Vs[c * D + d] = ok ? to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Kt[d * S::KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = ty * RPT + i;
      const int qp = q0 + row;
      bool keep[CPT];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool kk = kp < seq;
        if (causal) {
          kk = kk && qp >= kp;
          if (window > 0) kk = kk && qp - kp < window;
        }
        keep[j] = kk;
        s[i][j] = kk ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        // A fully-masked row would otherwise get exp(0) = 1 per entry.
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[row * S::PS + tx + 16 * j] = to_float(from_float<T>(p));
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * S::PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = q0 + ty * RPT + i;
    if (r >= seq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = o + ((size_t)bh * seq + r) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      orow[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * seq + r] = m[i] + logf(denom);
  }
}

// ---- bf16: tensor cores (wgmma) ------------------------------------------

constexpr int WG = 128;       // threads: one warpgroup
constexpr int WG_STAGES = 2;  // depth of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Q tile, then WG_STAGES x (K tile, V tile), each 1024-byte aligned.
template <int D>
struct WgSmem {
  using Tl = sm90::Tile<D, BQ>;
  static constexpr size_t bytes = 1024 + Tl::BYTES * (1 + 2 * WG_STAGES);
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_fwd_kernel_wgmma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int G, int seq,
                           float scale, int causal, int window) {
  static_assert(BQ == 64 && BK == 64, "one m64n64 score tile per KV tile");
  using Tl = sm90::Tile<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (sm90::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + Tl::BYTES;  // stage s: K at +2s tiles, V after

  const int tid = threadIdx.x;
  // Heaviest causal tiles first (the last q tiles see the most keys).
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQ;
  const __nv_bfloat16* kb = k + (size_t)kvh * seq * D;
  const __nv_bfloat16* vb = v + (size_t)kvh * seq * D;

  // The KV tiles this q tile needs (as flash_fwd_kernel).
  const int q_last = min(q0 + BQ, seq) - 1;
  int j_lo = 0, j_hi = (seq + BK - 1) / BK - 1;
  if (causal) {
    j_hi = q_last / BK;
    if (window > 0) j_lo = max(0, q0 - window + 1) / BK;
  }
  const int n_kv = j_hi - j_lo + 1;

  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t % WG_STAGES) * 2 * Tl::BYTES;
    const int k0 = (j_lo + t) * BK;
    sm90::load_tile<D, BK, WG>(dst, kb, k0, seq, tid);
    sm90::load_tile<D, BK, WG>(dst + Tl::BYTES, vb, k0, seq, tid);
  };
  // Prologue: Q with KV tile 0, then tiles 1 .. WG_STAGES - 2; one commit
  // group per KV tile, empty past the last, so the ring's waits count
  // uniformly (tile t is group t).
  sm90::load_tile<D, BQ, WG>(sQ, q + (size_t)bh * seq * D, q0, seq, tid);
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
        k0 + BK > seq ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * sl2;
          if (edge) {
            const int qp = q0 + r0 + 8 * i, kp = k0 + 8 * j + c0 + c;
            bool keep = kp < seq;
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
    const float denom = fmaxf(quad_sum(l[i]), 1e-20f);
    const int r = q0 + r0 + 8 * i;
    if (r >= seq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * seq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                acc[4 * j + 2 * i + 1] / denom);
    if (lse != nullptr && (tid & 3) == 0)
      lse[(size_t)bh * seq + r] = m[i] * LN2 + logf(denom);
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int G, int seq,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  auto kern = flash_fwd_kernel_wgmma<D>;
  const size_t smem = WgSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + BQ - 1) / BQ, B * H);
  using bf16 = __nv_bfloat16;
  kern<<<grid, WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, G, seq,
      scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int G, int seq, float scale,
                   int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, G, seq, scale,
      causal, window);
  return cudaGetLastError();
}

// f32 -> flash_fwd_kernel (FMA); bf16 -> flash_fwd_kernel_wgmma.
template <bool WGMMA>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int G, int seq, int D,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
#define DCT_FWD_CASE(DIM)                                                     \
  case DIM:                                                                   \
    return WGMMA ? launch_wgmma<DIM>(q, k, v, o, lse, B, H, G, seq, scale,    \
                                     causal, window, stream)                  \
                 : launch<float, DIM>(q, k, v, o, lse, B, H, G, seq, scale,   \
                                      causal, window, stream);
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

// q [B,H,T,D], k/v [B,G,T,D], o [B,H,T,D], all contiguous, of one dtype
// (0 = f32, 1 = bf16); lse [B,H,T] f32 or null.  window <= 0 means none.
extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int G, int seq,
                             int D, float scale, int causal, int window,
                             int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || seq <= 0 || H % G != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<false>(q, k, v, o, lse_f, B, H, G, seq, D, scale,
                                    causal, window, s);
  if (dtype == 1)
    return (int)dispatch_dim<true>(q, k, v, o, lse_f, B, H, G, seq, D, scale,
                                   causal, window, s);
  return (int)cudaErrorInvalidValue;
}
