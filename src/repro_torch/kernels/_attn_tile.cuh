// The tensor-core attention tile shared by the bf16 flash-attention and
// contiguous decode-attention kernels (sm_90a).
//
// One warp owns 16 query rows -- 16 queries of a flash q tile, or the G
// query heads of one kv head in decode, zero-padded to 16 -- and walks K/V
// tiles that the block stages in shared memory:
//   * S = Q K^T and O += P V run on the tensor cores through
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with f32
//     accumulators in registers (the usual FlashAttention-2 form);
//   * operands come from shared memory through ldmatrix (.x4, and .trans
//     for V).  Rows are padded by 16 bytes (LD = D + 8 elements): a row of
//     D/8 + 1 16-byte chunks, an odd number for every D that is a multiple
//     of 16, puts the 8 rows of an 8x8 matrix in 8 different 16-byte bank
//     groups, so ldmatrix has no bank conflicts at 160-byte (d = 80),
//     256-byte or 512-byte (d = 256) rows;
//   * tiles arrive by 16-byte cp.async.cg copies, which the kernels double
//     buffer: the next tile is in flight while the current one is
//     multiplied.  A row that no query may see is copied with src-size 0:
//     shared memory holds zeros and global memory is never read for it, so
//     a NaN there cannot reach the output through 0 * V;
//   * softmax is online in f32 and in log2 units (scores are scaled by
//     scale * log2(e) and exponentiated with exp2f).  Each lane holds two
//     rows (g = lane / 4 and g + 8); a row's max and sum are reduced across
//     the 4 lanes of its quad.  P is rounded to bf16 as the A operand of
//     P V; the running sum l adds the f32 probabilities.
//
// Why mma.sync and not wgmma + TMA: d = 80's 160-byte rows do not fit
// TMA's 128-byte swizzle in one box, and the prefix, window and ring masks
// come on top; a warpgroup/TMA pipeline for d = 128 and 256 is the next
// step for flash (ROADMAP).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 for .bf16): with g = lane / 4
// and t = lane % 4, an f32 accumulator c[4] of a 16x8 tile holds
// (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace attn_tile {

constexpr int kPad = 8;          // bf16 elements of padding per smem row
constexpr float kMasked = -INFINITY;   // the score of a masked key

__host__ __device__ constexpr int row_stride(int D) { return D + kPad; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage NROWS rows of D bf16 into shared memory (row stride LD) with
// NTHREADS threads: row r comes from src(r), or is zero where src(r)
// returns nullptr.  The caller commits the group.
template <int D, int NROWS, int NTHREADS, typename Src>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, Src src,
                                          const __nv_bfloat16* any_row,
                                          int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int LD = row_stride(D);
#pragma unroll 4
  for (int idx = tid; idx < NROWS * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const __nv_bfloat16* row = src(r);
    cp_async16(dst + r * LD + c * 8, (row ? row : any_row) + c * 8,
               row ? 16 : 0);
  }
}

// s = Q K^T for the warp's 16 query rows (q_rows, stride LD) against NKEY
// key rows (k_rows, stride LD), NKEY a multiple of 16: s[n] is the 16x8
// tile of keys 8n .. 8n+7.
template <int D, int NKEY>
__device__ __forceinline__ void scores(float (&s)[NKEY / 8][4],
                                       const __nv_bfloat16* q_rows,
                                       const __nv_bfloat16* k_rows, int lane) {
  constexpr int LD = row_stride(D);
#pragma unroll
  for (int n = 0; n < NKEY / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  // A: lanes 0-15 address rows 0-15 at the k-step's first 8 columns,
  // lanes 16-31 the same rows at its last 8.  B (K rows, i.e. K^T in
  // column-major): matrices (keys 0-7, dims lo), (0-7, hi), (8-15, lo),
  // (8-15, hi) of each 16-key pair give b0, b1 of two n-tiles.
  const __nv_bfloat16* qa = q_rows + (lane & 15) * LD + (lane >> 4) * 8;
  const __nv_bfloat16* kb =
      k_rows + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
    for (int np = 0; np < NKEY / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, kb + np * 16 * LD + kk * 16);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Online softmax step over one tile of raw scores s (masked entries are
// -inf): scales them by scale_log2, updates the running max m and sum l of
// the lane's two rows, rescales the accumulator o, and leaves the tile's
// probabilities in s.  A row that has seen no kept key yet keeps m = -inf
// and gets p = 0 (the max is replaced by 0 in the exponent, so -inf - -inf
// never happens).
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2],
                                             float (&l)[2], float (&o)[NO][4],
                                             float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kMasked;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][2 * r] *= scale_log2;
      s[n][2 * r + 1] *= scale_log2;
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    }
    const float m_new = fmaxf(m[r], quad_max(mx));
    const float m_use = m_new == kMasked ? 0.f : m_new;
    const float alpha = exp2f(m[r] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][2 * r] = exp2f(s[n][2 * r] - m_use);
      s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_use);
      sum += s[n][2 * r] + s[n][2 * r + 1];
    }
    l[r] = l[r] * alpha + sum;  // this lane's share; quad_sum at the end
    m[r] = m_new;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * r] *= alpha;
      o[n][2 * r + 1] *= alpha;
    }
  }
}

// o += P V: p the tile's probabilities (as scores() laid them out), v_rows
// NKEY rows of D (stride LD).  P's accumulator fragments are exactly the A
// fragments of P V once packed to bf16.
template <int D, int NKEY>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 8][4],
                                              const float (&p)[NKEY / 8][4],
                                              const __nv_bfloat16* v_rows,
                                              int lane) {
  constexpr int LD = row_stride(D);
  // B (V rows, row-major: .trans): matrices (keys 0-7, dims lo), (8-15,
  // lo), (0-7, hi), (8-15, hi) of each 16-dim pair give b0, b1 of two
  // n-tiles of o.
  const __nv_bfloat16* vb = v_rows + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < NKEY / 16; ++ks) {
    const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                           pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                           pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                           pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vb + ks * 16 * LD + dp * 16);
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace attn_tile
