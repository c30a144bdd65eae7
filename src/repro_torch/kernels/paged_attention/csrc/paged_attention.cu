// Paged decode attention for Hopper (sm_90a), f32 and bf16.
//
// Replaces repro/kernels/paged_attention/kernel.py:paged_decode_attention_fwd
// (Pallas _paged_kernel): one query token per sequence attends a
// block-paged KV pool [P, ps, KVH, d] through its page-table row.
//
// What bounds it: bytes.  Each valid (token, kv head) is read once as a
// K row and a V row; at G = H/KVH query rows per kv head the kernel does
// 4*G*d flops per 4*d bytes (bf16), far below the card's ~295 flop/byte
// ridge.  So the design reads only what it must:
//   * one block per (kv head, sequence) walks only positions
//     [start, length) -- never the pages past the sequence's length,
//     where the TPU kernel streamed all N pages and masked;
//   * the G query rows of a kv head share every K/V row load;
//   * the block reads its own page_table[b, j / ps] (no gather copy).
// Four warps take tokens round robin; within a warp the 32 lanes split
// the head dimension (lane + 32*i), so a K/V row is one coalesced load.
// Each warp keeps an online max/sum and an f32 accumulator per query
// row; the warps' partial states are merged through shared memory at the
// end.  Positions outside [start, length) are never visited, so a stale
// page can never poison the output, and a retired slot (table row all
// scratch page 0, stale length) reads only page 0 and stays finite.
//
// One block per (b, kv head) is 256 blocks at B=8 on stablelm-3b
// (KVH=32), enough for the 132 SMs.  When B*KVH is small against the SM
// count, split-K over pages (flash-decoding, with a second pass that
// merges the per-split max/sum/accumulator) is the later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1.0e30f;

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E = ceil(d / 32): head-dim elements per lane.
template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int KVH, int d, int ps, int N, int P, int window,
                    float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* m_s = smem;                  // [kWarps][G]
  float* l_s = m_s + kWarps * G;      // [kWarps][G]
  float* acc_s = l_s + kWarps * G;    // [kWarps][G][d]

  float qr[kMaxG][E], acc[kMaxG][E], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = lane + 32 * i;
      acc[g][i] = 0.f;
      qr[g][i] = (g < G && e < d)
                     ? to_f(q[((size_t)b * H + kvh * G + g) * d + e])
                     : 0.f;
    }
  }

  const int len = min(lengths[b], N * ps);
  const int start = window > 0 ? max(0, len - window) : 0;
  const int* row = page_table + (size_t)b * N;

  for (int j = start + warp; j < len; j += kWarps) {
    const int page = row[j / ps];
    if (page < 0 || page >= P) continue;  // never read outside the pool
    const size_t base = (((size_t)page * ps + (j % ps)) * KVH + kvh) * d;
    float kr[E], vr[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = lane + 32 * i;
      kr[i] = e < d ? to_f(k_pages[base + e]) : 0.f;
      vr[i] = e < d ? to_f(v_pages[base + e]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {  // uniform across the warp
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += qr[g][i] * kr[i];
        const float s = warp_sum(part) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int e = lane + 32 * i;
        if (e < d) acc_s[(warp * G + g) * d + e] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * d; idx += blockDim.x) {
    const int g = idx / d;
    const int e = idx - g * d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w * G + g] - mx);
      lsum += l_s[w * G + g] * c;
      o += acc_s[(w * G + g) * d + e] * c;
    }
    out[((size_t)b * H + kvh * G + g) * d + e] =
        from_f<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int KVH, int d, int ps, int N, int P, int window,
                   float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const dim3 grid(KVH, B);
  const size_t smem = (size_t)(2 * kWarps * G + kWarps * G * d) * sizeof(float);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define PAGED_CASE(E_)                                                      \
  case E_:                                                                  \
    paged_decode_kernel<T, E_><<<grid, kWarps * 32, smem, stream>>>(        \
        qt, kt, vt, table, lengths, ot, H, KVH, d, ps, N, P, window, scale); \
    break;
  switch ((d + 31) / 32) {
    PAGED_CASE(1)
    PAGED_CASE(2)
    PAGED_CASE(3)
    PAGED_CASE(4)
    PAGED_CASE(5)
    PAGED_CASE(6)
    PAGED_CASE(7)
    PAGED_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention_fwd(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int KVH, int d, int ps, int N, int P, int window, float scale,
    void* stream) {
  if (B == 0) return 0;
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_pages, v_pages, table, lens, out, B, H, KVH, d,
                        ps, N, P, window, scale, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, table, lens, out, B, H,
                                KVH, d, ps, N, P, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
