// Split-K (flash-decoding) partials shared by the decode-attention
// kernels (contiguous and paged, sm_90a): the tile kernels' block merge,
// which writes one split's partial per query head, and the combine
// kernel, which merges the splits' partials per (head, sequence).
//
// A partial is (m, l, acc): the split's max score in natural-log units,
// its sum of exp(score - m) and its f32 accumulator of exp(score - m) V.
// Row (b * H + h) * n_split + split of part_ml [.., 2] and part_acc
// [.., d].  A split that saw no kept key holds m = kEmptyMax, l = 0,
// acc = 0 and weighs nothing.
//
// The paged kernel splits each sequence into fixed chunks of the page
// table's width, whatever its length, so most of a short sequence's
// blocks have nothing to do: they exit at once and write nothing, and
// the combine reads `lengths` (on the device) to merge only the splits
// that overlap the sequence's kept range [start, len).  The wrapper never
// reads the lengths on the host.

#pragma once

#include "_attn_tile.cuh"

namespace attn_tile {

constexpr float kEmptyMax = -1.0e30f;  // m of a split with no kept key
constexpr int kCombineThreads = 128;

// The kept positions [start, len) of a sequence of `length` tokens, as
// the reference keeps them: positions below both `length` and `cap` (the
// page table's reach), and under a window (> 0) at or past
// length - window (the uncapped length; start <= len).
__host__ __device__ __forceinline__ void kept_range(int length, int cap,
                                                    int window, int& start,
                                                    int& len) {
  len = length < 0 ? 0 : (length < cap ? length : cap);
  start = window > 0 && length > window ? length - window : 0;
  start = start < len ? start : len;
}

// Whether the chunk [j0, j0 + chunk) overlaps [start, len).
__host__ __device__ __forceinline__ bool chunk_live(int j0, int chunk,
                                                    int start, int len) {
  return j0 < len && j0 + chunk > start;
}

// Merge the block's NWARPS warps' (m, l, O) -- each warp's state over its
// own keys, as softmax_step left it, in log2 units -- through `smem` (at
// least NWARPS * (16 * D + 32) floats, free for reuse), and write rows
// 0 .. G-1 as this split's partial of query heads row0 + r.  Every thread
// of the block calls it, after a __syncthreads that frees smem.
template <int D, int NWARPS>
__device__ __forceinline__ void store_partial(
    float (&o)[D / 8][4], const float (&m)[2], float (&l)[2], float* smem,
    int G, size_t row0, int n_split, int split, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* o_s = smem;                      // [NWARPS][16][D]
  float* ml_s = o_s + NWARPS * 16 * D;    // [NWARPS][16][2]
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  float* ow = o_s + warp * 16 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(ow + g * D + c) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(ow + (g + 8) * D + c) =
        make_float2(o[n][2], o[n][3]);
  }
  if (t == 0) {
    float* mlw = ml_s + warp * 32;
    mlw[2 * g] = m[0];
    mlw[2 * g + 1] = l[0];
    mlw[2 * (g + 8)] = m[1];
    mlw[2 * (g + 8) + 1] = l[1];
  }
  __syncthreads();
  constexpr float kLn2 = 0.6931471805599453f;
  for (int idx = tid; idx < G * D; idx += NWARPS * 32) {
    const int r = idx / D;
    const int e = idx - r * D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, ml_s[w * 32 + 2 * r]);
    float lsum = 0.f, acc = 0.f;
    if (mx != kMasked) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float c = exp2f(ml_s[w * 32 + 2 * r] - mx);
        lsum += ml_s[w * 32 + 2 * r + 1] * c;
        acc += o_s[(w * 16 + r) * D + e] * c;
      }
    }
    const size_t prow = (row0 + r) * n_split + split;
    part_acc[prow * D + e] = acc;
    if (e == 0) {
      part_ml[prow * 2] = mx != kMasked ? mx * kLn2 : kEmptyMax;
      part_ml[prow * 2 + 1] = lsum;
    }
  }
}

template <typename T>
__device__ __forceinline__ T out_as(float x);
template <>
__device__ __forceinline__ float out_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 out_as<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Merge the splits' partials of one (head, b) = (blockIdx.x, blockIdx.y)
// into out [B, H, d].  With `lengths` null every split is merged (each
// wrote a partial); otherwise only those whose chunk overlaps the kept
// range of lengths[b] (kept_range with cap and window): the others never
// ran, and their partials are never read.  A row with no kept key gives
// 0 (l is floored at 1e-30).
template <typename Tq>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, Tq* __restrict__ out,
                      int H, int d, int n_split,
                      const int* __restrict__ lengths, int cap, int window,
                      int chunk) {
  const size_t row = (size_t)blockIdx.y * H + blockIdx.x;
  int s0 = 0, s1 = n_split;
  if (lengths != nullptr) {
    int start, len;
    kept_range(lengths[blockIdx.y], cap, window, start, len);
    s0 = start / chunk;
    s1 = min(n_split, (len + chunk - 1) / chunk);
  }
  const float* ml = part_ml + row * n_split * 2;
  float mx = kEmptyMax;
  for (int s = s0; s < s1; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int e = threadIdx.x; e < d; e += kCombineThreads) {
    float lsum = 0.f, o = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float c = expf(ml[2 * s] - mx);
      lsum += ml[2 * s + 1] * c;
      o += part_acc[(row * n_split + s) * d + e] * c;
    }
    out[row * d + e] = out_as<Tq>(o / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace attn_tile
