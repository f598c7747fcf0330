// Flash-attention backward for Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces: dct_tpu/ops/pallas_attention.py, driven by `_flash_bwd`
// (:427-544):
// - `_flash_bwd_dkdv_kernel` (:303-370, the pl.pallas_call at :487) ->
//   flash_bwd_dkdv_kernel below;
// - `_flash_bwd_dq_kernel` (:373-424, the pl.pallas_call at :529) ->
//   flash_bwd_dq_kernel below.
//
// Both recover the softmax from the forward's f32 log-sum-exp and compute,
// per (q, k) pair of a tile:
//   P  = exp(scale * q.k - lse)          (0 where the causal/window mask drops)
//   dP = dO.v
//   dS = P * (dP - delta) * scale,  delta = rowsum(dO * O)
// then dV += P^T dO and dK += dS^T Q (kernel 2), dQ += dS K (kernel 3), all
// accumulated in f32.  delta is computed inside each kernel, as the TPU
// kernels do (:333, :392): each q tile's rows read their O row once and
// reduce dO*O in f32 across the 16 lanes of the row group; no pre-pass and
// no [B*H, T] side buffer.  bf16 rounding happens exactly where the TPU
// kernel casts: P is rounded to dO's dtype before P^T dO, dS to the input
// dtype before dS^T Q and dS K; lse and delta stay f32.
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
// Kernel 3: the forward's j_lo/j_hi (:512-523).  The masks of :338-344 and
// :397-406 stay for the edge tiles and for a ragged T.
//
// What bounds it on this card.  At the training shape (B=32, H=G=8, T=1024,
// D=64, not causal) kernel 2 does 8*D flops per (q, k) pair (S, dP, dV, dK)
// = 137 GFLOP and kernel 3 does 6*D = 103 GFLOP (S and dP are recomputed
// in both, as on the TPU); their compulsory traffic is 5 [B*H, T, D] inputs
// plus lse and one or two outputs, about 0.47 GB in f32.  On the H100's
// datasheet rates (3.35 TB/s; 989 TFLOP/s bf16 dense on the tensor cores;
// f32 accuracy on the tensor cores as 3xTF32, three TF32 products at 495
// TFLOP/s, 165 TFLOP/s in effect) both are bound by operations: 0.14 and
// 0.10 ms in bf16 (against 0.07 and 0.06 ms of bytes), 0.83 and 0.62 ms in
// f32.  The f32 kernels below still run on the FMA units (67 TFLOP/s: 2.05
// and 1.54 ms at best); their 3xTF32 redesign is queued.
//
// What the design does about it.  As in flash_fwd.cu, nothing O(T^2)
// reaches device memory: a block's K and V tiles (kernel 2) or Q and dO
// tiles (kernel 3) stay in shared memory for its life and the other
// operands stream through in 64-row tiles.  Four kernels:
//
// - bf16 dK/dV: flash_bwd_dkdv_kernel_wgmma, on the tensor cores.  One
//   warpgroup (128 threads) owns 64 keys of one KV head; its K and V tiles
//   stay in swizzled shared memory and its dK and dV accumulators in
//   registers.  Q, dO, O and lse stream through a 2-stage cp.async ring.
//   The scores are computed transposed, S^T = K.Q^T and dP^T = V.dO^T (wgmma,
//   both operands from shared memory), so a thread's accumulator columns
//   are q rows: lse and delta are read per column from a shared vector,
//   and P^T = ex2.approx(S^T * scale * log2(e) - lse * log2(e)).
//   P^T and dS^T are rounded to bf16 in registers and are the register A
//   operands of dV += P^T.dO and dK += dS^T.Q, with dO and Q as MN-major B
//   operands of the same stage: P and dS never touch shared memory.  delta
//   is reduced from the stage's dO and O while the score products run.
//   Shared memory 66 KiB at D=64, 130 KiB at D=128.  Helpers: sm90.cuh.
// - bf16 dQ: flash_bwd_dq_kernel_wgmma, on the tensor cores.  One
//   warpgroup owns 64 q rows of one q head; its Q and dO tiles stay in
//   swizzled shared memory and its dQ accumulator in registers (f32, stored
//   once as bf16).  K and V stream through a 2-stage cp.async ring.
//   S = Q.K^T and dP = dO.V^T are issued back to back (both operands
//   K-major from shared memory) and waited on once.  The scores are not
//   transposed here, so a thread's accumulator rows are its q rows: lse and
//   delta are two registers per thread (delta = rowsum(dO * O) in f32, each
//   row from the 4 threads of its quad, read once from device memory), and
//   no shared vector is needed.  dS = P (dP - delta) scale is rounded to
//   bf16 in registers and is the register A operand of dQ += dS.K, the
//   stage's K tile serving as the MN-major B operand (N = D): dS never
//   touches shared memory, and one block owns its dQ tile, so no atomics
//   and the same bits from two launches.  Shared memory 49 KiB at D=64,
//   97 KiB at D=128.
// - f32 dK/dV and f32 dQ: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel,
//   on the f32 FMA units (no TF32).  Each of the 256 threads holds a 4x4
//   block of S and dP and a 4 x D/16 block of each accumulator in
//   registers; the transposed products read P and dS back from shared
//   memory; tiles are held as f32 in shared memory.  Shared memory: 100.5
//   KiB (kernel 2) and 83.5 KiB (kernel 3) at D=64, 165 KiB and 148 KiB at
//   D=128.
//
// Each C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;  // tile rows per thread
constexpr int CPT = BK / 16;  // score columns per thread

// The FMA kernels are instantiated for f32 only (bf16 takes the tensor-core
// kernels); these are their conversions.
__device__ __forceinline__ float to_float(float x) { return x; }

// Round an f32 value to T and back (the TPU kernel's `.astype(dtype)`).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared-memory row strides (as flash_fwd.cu): row tiles padded by 4 floats
// so the two row groups of a warp (rows 4 apart) fall in opposite halves of
// the banks; transposed tiles padded by 1 so column reads spread.
template <int D>
struct Strides {
  static constexpr int QS = D + 4;   // Q, dO: [BQ][QS]
  static constexpr int KS = BK + 1;  // K^T, V^T: [D][KS]
  static constexpr int PS = BK + 4;  // P, dS: [BQ][PS]
};

template <int D>
struct DkdvSmem {
  using S = Strides<D>;
  static constexpr int floats = 2 * D * S::KS + 2 * BQ * S::QS + 2 * BQ * S::PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <int D>
struct DqSmem {
  using S = Strides<D>;
  static constexpr int floats = 2 * D * S::KS + 2 * BQ * S::QS + BQ * S::PS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ bool keep_pair(int qp, int kp, int seq, int causal,
                                          int window) {
  bool kk = qp < seq && kp < seq;
  if (causal) {
    kk = kk && qp >= kp;
    if (window > 0) kk = kk && qp - kp < window;
  }
  return kk;
}

// Load a [rows][D] tile starting at row r0 of a [seq][D] head into shared
// memory as f32 with row stride `ld` (rows past seq are zero).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int r0, int seq, int tid) {
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * ld + d] = r0 + r < seq ? to_float(src[(size_t)(r0 + r) * D + d]) : 0.f;
  }
}

// Load the K and V tiles starting at key k0, transposed: Kt[d][c], Vt[d][c].
template <typename T, int D>
__device__ __forceinline__ void load_kv_t(float* Kt, float* Vt, const T* kb,
                                          const T* vb, int k0, int seq,
                                          int tid) {
  constexpr int KS = Strides<D>::KS;
  for (int i = tid; i < BK * D; i += NT) {
    const int c = i / D, d = i % D;
    const bool ok = k0 + c < seq;
    const size_t g = (size_t)(k0 + c) * D + d;
    Kt[d * KS + c] = ok ? to_float(kb[g]) : 0.f;
    Vt[d * KS + c] = ok ? to_float(vb[g]) : 0.f;
  }
}

// Per-row lse and delta = rowsum(dO * O) for the thread's RPT rows of the q
// tile at q0 (dO already in shared memory; O read from device memory).
template <typename T, int D>
__device__ __forceinline__ void row_stats(float (&lse_r)[RPT],
                                          float (&delta_r)[RPT],
                                          const float* dOs, const T* ob,
                                          const float* lseb, int q0, int seq,
                                          int ty, int tx) {
  constexpr int QS = Strides<D>::QS;
  constexpr int DPT = D / 16;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ty * RPT + i;
    const int qp = q0 + row;
    float part = 0.f;
    if (qp < seq) {
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = tx + 16 * j;
        part = fmaf(dOs[row * QS + d], to_float(ob[(size_t)qp * D + d]), part);
      }
    }
    delta_r[i] = sum16(part);
    lse_r[i] = qp < seq ? lseb[qp] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for the thread's 4x4 block (rows ty*RPT+i,
// columns tx+16*j), then P and dS in f32.
template <int D>
__device__ __forceinline__ void scores(float (&p)[RPT][CPT],
                                       float (&ds)[RPT][CPT], const float* Qs,
                                       const float* dOs, const float* Kt,
                                       const float* Vt,
                                       const float (&lse_r)[RPT],
                                       const float (&delta_r)[RPT], int q0,
                                       int k0, int seq, float scale,
                                       int causal, int window, int ty,
                                       int tx) {
  using S = Strides<D>;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = Qs[(ty * RPT + i) * S::QS + d];
      gv[i] = dOs[(ty * RPT + i) * S::QS + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = Kt[d * S::KS + tx + 16 * j];
      vv[j] = Vt[d * S::KS + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kp = k0 + tx + 16 * j;
      const float pij = keep_pair(qp, kp, seq, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - delta_r[i]) * scale;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int G, int seq,
                          float scale, int causal, int window) {
  using S = Strides<D>;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Kt = smem;                 // [D][KS]
  float* Vt = Kt + D * S::KS;       // [D][KS]
  float* Qs = Vt + D * S::KS;       // [BQ][QS]
  float* dOs = Qs + BQ * S::QS;     // [BQ][QS]
  float* Ps = dOs + BQ * S::QS;     // [BQ][PS]
  float* dSs = Ps + BQ * S::PS;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // Causal: the first KV tiles see the most q tiles; they launch first.
  const int jt = blockIdx.x;
  const int bg = blockIdx.y;  // flat b*G + g
  const int b = bg / G, g = bg % G;
  const int group = H / G;
  const int k0 = jt * BK;

  load_kv_t<T, D>(Kt, Vt, k + (size_t)bg * seq * D, v + (size_t)bg * seq * D,
                  k0, seq, tid);

  float acc_k[RPT][DPT], acc_v[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // The q tiles that reach this KV tile: causal starts at the diagonal, a
  // window ends where the band of the tile's last key runs out.
  const int n_q = (seq + BQ - 1) / BQ;
  int i_lo = 0, i_hi = n_q - 1;
  if (causal) {
    i_lo = k0 / BQ;
    if (window > 0) i_hi = min(i_hi, (window + k0 + BK - 2) / BQ);
  }

  for (int m = 0; m < group; ++m) {
    const int bh = b * H + g * group + m;  // the member's flat q head
    const T* qb = q + (size_t)bh * seq * D;
    const T* ob = o + (size_t)bh * seq * D;
    const T* gb = dout + (size_t)bh * seq * D;
    const float* lseb = lse + (size_t)bh * seq;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D>(Qs, S::QS, qb, q0, seq, tid);
      load_rows<T, D>(dOs, S::QS, gb, q0, seq, tid);
      __syncthreads();

      float lse_r[RPT], delta_r[RPT];
      row_stats<T, D>(lse_r, delta_r, dOs, ob, lseb, q0, seq, ty, tx);
      float p[RPT][CPT], ds[RPT][CPT];
      scores<D>(p, ds, Qs, dOs, Kt, Vt, lse_r, delta_r, q0, k0, seq, scale,
                causal, window, ty, tx);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int idx = (ty * RPT + i) * S::PS + tx + 16 * j;
          Ps[idx] = round_to<T>(p[i][j]);
          dSs[idx] = round_to<T>(ds[i][j]);
        }
      __syncthreads();

      // dV[c] += sum_r P[r][c] dO[r];  dK[c] += sum_r dS[r][c] Q[r], for the
      // thread's key rows c = ty*RPT+i and columns tx+16*j.
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], sv[RPT], gv[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * S::PS + ty * RPT + i];
          sv[i] = dSs[r * S::PS + ty * RPT + i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          gv[j] = dOs[r * S::QS + tx + 16 * j];
          qv[j] = Qs[r * S::QS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty * RPT + i;
    if (kp >= seq) continue;
    const size_t row = ((size_t)bg * seq + kp) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dk[row + tx + 16 * j] = from_float<T>(acc_k[i][j]);
      dv[row + tx + 16 * j] = from_float<T>(acc_v[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        int H, int G, int seq, float scale, int causal,
                        int window) {
  using S = Strides<D>;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* Kt = smem;              // [D][KS]
  float* Vt = Kt + D * S::KS;    // [D][KS]
  float* Qs = Vt + D * S::KS;    // [BQ][QS]
  float* dOs = Qs + BQ * S::QS;  // [BQ][QS]
  float* dSs = dOs + BQ * S::QS;  // [BQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // Causal: the last q tiles see the most keys; they launch first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // flat b*H + h
  const int b = bh / H;
  const int kvh = b * G + (bh % H) / (H / G);
  const int q0 = qt * BQ;

  const T* kb = k + (size_t)kvh * seq * D;
  const T* vb = v + (size_t)kvh * seq * D;
  load_rows<T, D>(Qs, S::QS, q + (size_t)bh * seq * D, q0, seq, tid);
  load_rows<T, D>(dOs, S::QS, dout + (size_t)bh * seq * D, q0, seq, tid);
  __syncthreads();
  float lse_r[RPT], delta_r[RPT];
  row_stats<T, D>(lse_r, delta_r, dOs, o + (size_t)bh * seq * D,
                  lse + (size_t)bh * seq, q0, seq, ty, tx);

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  // The forward's KV range for this q tile.
  int j_lo;
  const int n_kv = sm90::kv_tiles(q0, BQ, BK, seq, causal, window, j_lo);
  const int j_end = j_lo + n_kv;

  for (int jt = j_lo; jt < j_end; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile's readers of Kt, Vt, dSs are done
    load_kv_t<T, D>(Kt, Vt, kb, vb, k0, seq, tid);
    __syncthreads();

    float p[RPT][CPT], ds[RPT][CPT];
    scores<D>(p, ds, Qs, dOs, Kt, Vt, lse_r, delta_r, q0, k0, seq, scale,
              causal, window, ty, tx);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        dSs[(ty * RPT + i) * S::PS + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dQ[r] += sum_c dS[r][c] K[c], K read back from its transposed tile.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = dSs[(ty * RPT + i) * S::PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = Kt[(tx + 16 * j) * S::KS + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty * RPT + i;
    if (qp >= seq) continue;
    T* row = dq + ((size_t)bh * seq + qp) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) row[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
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

  // The q tiles that reach this KV tile (as flash_bwd_dkdv_kernel).
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

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv;
  int B, H, G, seq;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dkdv(const Args& a) {
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  const size_t smem = DkdvSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + BK - 1) / BK, a.B * a.G);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.G, a.seq, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

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

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.seq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<T*>(a.dq), a.H, a.G, a.seq, a.scale, a.causal, a.window);
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

// f32 -> flash_bwd_dkdv_kernel, flash_bwd_dq_kernel (FMA); bf16 ->
// flash_bwd_dkdv_kernel_wgmma, flash_bwd_dq_kernel_wgmma.
template <bool DKDV, typename T>
cudaError_t dispatch_dim(const Args& a, int D) {
  constexpr bool BF16 = !std::is_same<T, float>::value;
#define DCT_BWD_CASE(DIM)                                                \
  case DIM:                                                              \
    if constexpr (DKDV && BF16) return launch_dkdv_wgmma<DIM>(a);        \
    else if constexpr (DKDV) return launch_dkdv<T, DIM>(a);              \
    else if constexpr (BF16) return launch_dq_wgmma<DIM>(a);             \
    else return launch_dq<T, DIM>(a);
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
  if (dtype == 0) return (int)dispatch_dim<DKDV, float>(a, D);
  if (dtype == 1) return (int)dispatch_dim<DKDV, __nv_bfloat16>(a, D);
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
