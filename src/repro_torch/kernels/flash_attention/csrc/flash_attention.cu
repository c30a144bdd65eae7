// Flash attention forward with an optional padded prefix, for Hopper
// (sm_90a), f32 and bf16.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (Pallas _fa_kernel), extended with the serving engine's prefix mode:
// keys are `prefix_pad` rows of a padded, already-prefilled prefix (the
// first `prefix_len` valid) followed by the queries' own rows.  Query i
// keeps key j iff j < prefix_len, or j >= prefix_pad and
// j - prefix_pad <= i (causal) and j - prefix_pad > i - window (window).
// With prefix_pad = prefix_len = 0 that is _fa_kernel's mask.
//
// What bounds it: at the engine's prefill chunks on stablelm-3b (256
// queries over a 512-row padded prefix, H = KVH, d = 80) the bytes: q,
// the kept K/V rows and the output move once, and the 4*d flops per kept
// (row, key) pair take less time at the bf16 tensor-core peak than those
// bytes take at HBM rate.  Operations become the bound from roughly a
// thousand queries on, or sooner under GQA, where G query heads share
// each K/V row (40:8 at d = 128 is already there at 256 queries).  What
// this first version hits is neither: it computes in f32 FMAs on the
// CUDA cores (no wgmma/TMA yet), two orders of magnitude over the bound
// (PERF.md).  What it does meanwhile:
//   * one block per (q tile of 32 rows, head, batch) keeps its q tile in
//     shared memory and streams K/V tiles of 32 keys of kv head h / G
//     through shared memory, so each K/V row is loaded once per q tile;
//   * key tiles that no row of the q tile can see (above the causal
//     diagonal, outside the window, or prefix padding) are skipped
//     before they are loaded, and the loop stops at the last key the
//     tile's last row can see;
//   * in a tile, each lane scores one key for 8 query rows at a time
//     (one shared-memory K read feeds 8 FMAs), the online max/sum is a
//     warp reduction, and P@V runs only over the keys that row keeps
//     (a ballot), so masked or out-of-range V rows are never multiplied
//     in.  Out-of-range rows are also loaded as zeros.
// Softmax is online in f32 (running max m, sum l, accumulator acc per
// row); the output is acc / max(l, 1e-30) in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kKT = 32;                  // keys per tile (one per lane)
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Mask {
  int causal, window, prefix_pad, prefix_len;

  __device__ __forceinline__ bool keep(int i, int j) const {
    if (j < prefix_len) return true;
    if (j < prefix_pad) return false;
    const int rel = j - prefix_pad;
    if (causal && rel > i) return false;
    if (window > 0 && rel <= i - window) return false;
    return true;
  }

  // Can any query row in [qlo, qhi] keep any key in [k0, k1]?
  __device__ __forceinline__ bool tile_live(int qlo, int qhi, int k0,
                                            int k1) const {
    if (k0 < prefix_len) return true;
    const int lo = max(k0, prefix_pad);
    if (lo > k1) return false;
    if (causal && lo - prefix_pad > qhi) return false;
    if (window > 0 && k1 - prefix_pad <= qlo - window) return false;
    return true;
  }
};

// E = ceil(d / 32): head-dim elements per lane in the accumulator.
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_,
                 int H, int KVH, int d, Mask mask, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qhi = min(q0 + kBQ, S) - 1;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBQ][d]
  float* k_s = q_s + kBQ * d;           // [kKT][d + 1] (padded: no conflicts)
  float* v_s = k_s + kKT * (d + 1);     // [kKT][d]

  for (int idx = threadIdx.x; idx < kBQ * d; idx += blockDim.x) {
    const int r = idx / d;
    const int e = idx - r * d;
    const int qi = q0 + r;
    q_s[idx] = qi < S ? to_f(q[(((size_t)b * S + qi) * H + h) * d + e]) : 0.f;
  }

  float acc[kRows][E], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.f;
  }

  // the last key the tile's last row can see (causal), and the first
  // one its first row can see (window, when no prefix key is valid)
  const int kend = mask.causal ? min(T_, mask.prefix_pad + qhi + 1) : T_;
  int kbeg = 0;
  if (mask.window > 0 && mask.prefix_len == 0)
    kbeg = max(0, mask.prefix_pad + q0 - mask.window + 1);

  for (int k0 = kbeg; k0 < kend; k0 += kKT) {
    const int k1 = min(k0 + kKT, T_) - 1;
    if (!mask.tile_live(q0, qhi, k0, k1)) continue;  // uniform per block
    __syncthreads();  // q tile stored / previous K,V tile consumed
    for (int idx = threadIdx.x; idx < kKT * d; idx += blockDim.x) {
      const int jj = idx / d;
      const int e = idx - jj * d;
      const int j = k0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < T_) {
        const size_t off = (((size_t)b * T_ + j) * KVH + kvh) * d + e;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[jj * (d + 1) + e] = kv;
      v_s[jj * d + e] = vv;
    }
    __syncthreads();

    // scores of key k0 + lane against this warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * (d + 1);
    const float* qrow = q_s + warp * kRows * d;
    for (int e = 0; e < d; ++e) {
      const float kv = krow[e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qrow[r * d + e] * kv;
    }

    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const bool ok = qi < S && j <= k1 && mask.keep(qi, j);
      unsigned keep = __ballot_sync(kFull, ok);
      if (keep == 0u) continue;  // uniform across the warp
      const float sv = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= alpha;
      while (keep) {
        const int jj = __ffs(keep) - 1;
        keep &= keep - 1;
        const float pj = __shfl_sync(kFull, p, jj);
        const float* vrow = v_s + jj * d;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int e = lane + 32 * i;
          if (e < d) acc[r][i] += pj * vrow[e];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = lane + 32 * i;
      if (e < d)
        out[(((size_t)b * S + qi) * H + h) * d + e] = from_f<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int E>
cudaError_t launch_e(const T* q, const T* k, const T* v, T* out, int B, int S,
                     int T_, int H, int KVH, int d, Mask mask, float scale,
                     cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ * d + kKT * (d + 1) + kKT * d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, E><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, out, S, T_, H, KVH, d, mask, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_, int H, int KVH, int d, Mask mask,
                   float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch ((d + 31) / 32) {
#define FLASH_CASE(E_) \
  case E_:             \
    return launch_e<T, E_>(qt, kt, vt, ot, B, S, T_, H, KVH, d, mask, scale, stream);
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
#undef FLASH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int T, int H, int KVH, int d, int causal,
                                   int window, int prefix_pad, int prefix_len,
                                   float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  const Mask mask{causal, window, prefix_pad, prefix_len};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, out, B, S, T, H, KVH, d, mask, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, KVH, d, mask, scale,
                                s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
