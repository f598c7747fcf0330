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
// memory: one thread block owns a 64-row q tile (in shared memory) and walks
// the KV tiles in a loop -- the loop replaces the TPU's sequential third grid
// axis, and the causal/window tile skip becomes the loop's bounds (replacing
// the clamped index maps at :218-235).  Each of the 256 threads holds a 4x4
// block of scores and a 4 x D/16 block of the output accumulator in
// registers, with the row statistics (m, l) replicated in the 16 threads of
// a row group, so the per-row rescale needs no shared memory.  Each K/V tile
// is read from device memory once per q tile; blocks run q-tile-major so the
// q tiles of one head share its K/V in L2.  This version multiplies on the
// FMA units in full f32 for both dtypes (no TF32, no tensor cores): it is
// the simple kernel that is right.  Reaching the bf16 bound needs wgmma with
// TMA-fed tiles, which is later work.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NT = 256;        // threads: 16 row groups x 16 column lanes
constexpr int RPT = BQ / 16;   // q rows per thread
constexpr int CPT = BK / 16;   // score columns per thread
constexpr float NEG = -1e30f;  // finite "minus infinity", the TPU kernel's _NEG

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int G, int seq, int D,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, G, seq, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, G, seq, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, G, seq, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, G, seq, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
    return (int)dispatch_dim<float>(q, k, v, o, lse_f, B, H, G, seq, D, scale,
                                    causal, window, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, o, lse_f, B, H, G, seq,
                                            D, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
