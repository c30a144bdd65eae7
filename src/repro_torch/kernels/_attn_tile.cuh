// The tensor-core attention tile shared by the bf16 flash-attention,
// contiguous decode-attention (bf16 and int8 K/V) and paged
// decode-attention kernels (sm_90a).
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
//   * int8 K/V rows are staged as bytes and converted to bf16 in shared
//     memory, exactly (|x| <= 127 fits bf16's 8-bit significand); their
//     per-key scales stay out of the operands and are applied to S's
//     columns (k) and to P before it is rounded to bf16 (v);
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
#include <type_traits>

namespace attn_tile {

constexpr int kPad = 8;          // bf16 elements of padding per smem row
constexpr float kMasked = -INFINITY;   // the score of a masked key

__host__ __device__ constexpr int row_stride(int D) { return D + kPad; }

// Let `kern` take `smem` bytes of dynamic shared memory (above 48 KB it
// must ask first).
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)smem)
             : cudaSuccess;
}

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
// 4 bytes global -> shared (through L1: .cg takes 16 bytes only);
// src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// Stage NROWS int8 rows of D bytes (row stride D) with NTHREADS
// threads, as load_rows does for bf16 rows.
template <int D, int NROWS, int NTHREADS, typename Src>
__device__ __forceinline__ void load_rows_i8(int8_t* dst, Src src,
                                             const int8_t* any_row, int tid) {
  constexpr int kChunks = D / 16;  // 16-byte chunks per row
#pragma unroll 4
  for (int idx = tid; idx < NROWS * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const int8_t* row = src(r);
    cp_async16(dst + r * D + c * 16, (row ? row : any_row) + c * 16,
               row ? 16 : 0);
  }
}

// 4 int8 (one word) -> 4 bf16 (two words), exactly: x + 128 goes into
// the low byte of 2^23's f32 significand, 2^23 + 128 is subtracted (an
// exact f32 difference), and the f32's upper half is the bf16 (x has at
// most 8 significant bits, so its lower half is zero).
__device__ __forceinline__ float i8_byte_to_f32(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) -
         8388736.f;  // 2^23 + 128
}
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(i8_byte_to_f32(u, 0));
  const uint32_t f1 = __float_as_uint(i8_byte_to_f32(u, 1));
  const uint32_t f2 = __float_as_uint(i8_byte_to_f32(u, 2));
  const uint32_t f3 = __float_as_uint(i8_byte_to_f32(u, 3));
  return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}

// dst [NROWS][LD] bf16 = src [NROWS][D] int8, with NTHREADS threads, 16
// values a step.
template <int D, int NROWS, int NTHREADS>
__device__ __forceinline__ void convert_rows_i8(__nv_bfloat16* dst,
                                                const int8_t* src, int tid) {
  constexpr int kChunks = D / 16;
  constexpr int LD = row_stride(D);
#pragma unroll 4
  for (int idx = tid; idx < NROWS * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * D + c * 16);
    const uint2 a = i8x4_to_bf16x4(w.x), b = i8x4_to_bf16x4(w.y);
    const uint2 e = i8x4_to_bf16x4(w.z), f = i8x4_to_bf16x4(w.w);
    uint4* out = reinterpret_cast<uint4*>(dst + r * LD + c * 16);
    out[0] = make_uint4(a.x, a.y, b.x, b.y);
    out[1] = make_uint4(e.x, e.y, f.x, f.y);
  }
}

// The key (column) of a warp's 16-key score tile that fragment entry
// s[n][e] holds.
__device__ __forceinline__ int key_of(int n, int e, int lane) {
  return n * 8 + 2 * (lane & 3) + (e & 1);
}

// Scores of the keys whose bit in `keep` is unset become -inf.
template <int NS>
__device__ __forceinline__ void mask_keys(float (&s)[NS][4], unsigned keep,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!((keep >> key_of(n, e, lane)) & 1u)) s[n][e] = kMasked;
}

// s[n][e] *= f[key]: a per-key factor (f: the warp's keys' factors in
// shared memory), the int8 path's k scale on S and v scale on P.
template <int NS>
__device__ __forceinline__ void scale_keys(float (&s)[NS][4], const float* f,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] *= f[key_of(n, e, lane)];
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

// ---------------------------------------------------------------------------
// The decode kernels' block loop (contiguous bf16, contiguous int8 and
// paged bf16): a block of 4 warps, the G query heads of one kv head as
// the 16 A rows, 64-position K/V tiles staged by cp.async in a double
// buffer, warp w taking positions 16w .. 16w+15 of each tile.

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeTile = kDecodeWarps * 16;  // positions per K/V tile

// Shared memory of decode_tiles for K/V of type T: q [16][LD] and, for
// bf16, two K and two V tiles [64][LD]; for int8, one bf16 K and V tile
// [64][LD], two int8 K and V staging tiles [64][D] and two k and v scale
// rows [64].  Once the loop is done all of it is free: store_partial's
// merge of 4 warps' O [16][D] in f32 fits from its start.
template <int D, typename T>
__host__ __device__ constexpr size_t decode_smem_bytes() {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  return (size_t)(16 + (kInt8 ? 2 : 4) * kDecodeTile) * row_stride(D) *
             sizeof(__nv_bfloat16) +
         (kInt8 ? (size_t)2 * 2 * kDecodeTile * (D + 4) : 0);
}

// Attend the G query rows qb [G][D] to the kept positions of the tiles
// [t0, t_end) (t0 on the caller's tile grid) and leave each warp's online
// softmax state over its own keys in (o, m, l), as softmax_step keeps it.
// keep(j) says whether position j is read, and row(j), asked only where
// it is, gives its row of K and V (in rows of D elements; for int8 also
// its scales' index).  A position not kept has its rows and scales never
// loaded (zeros arrive) and its score -inf, and a warp with no kept
// position in a tile skips it.  int8 rows are staged as bytes and
// converted to one bf16 tile exactly; k_scale multiplies S's columns
// before the softmax, v_scale multiplies P before its bf16 rounding, and
// l sums the unscaled P.  Every thread of the block calls it; on return
// all copies have landed and smem is free.
template <int D, typename T, typename Keep, typename Row>
__device__ __forceinline__ void decode_tiles(
    unsigned char* smem, const __nv_bfloat16* qb, int G, const T* k,
    const T* v, const float* k_scale, const float* v_scale, Keep keep,
    Row row, int t0, int t_end, float scale_log2, float (&o)[D / 8][4],
    float (&m)[2], float (&l)[2]) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static_assert(kInt8 || std::is_same<T, __nv_bfloat16>::value,
                "K/V: bf16 or int8");
  static_assert(D % 16 == 0 && D <= 256, "d: a multiple of 16 up to 256");
  constexpr int LD = row_stride(D);
  constexpr int kT = kDecodeTile;
  constexpr int kBufs = kInt8 ? 1 : 2;  // bf16 K/V tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + 16 * LD;          // [kBufs][kT][LD]
  __nv_bfloat16* v_s = k_s + kBufs * kT * LD;  // [kBufs][kT][LD]
  int8_t* k8_s = reinterpret_cast<int8_t*>(v_s + kBufs * kT * LD);
  int8_t* v8_s = k8_s + 2 * kT * D;            // int8: both [2][kT][D]
  float* ks_s = reinterpret_cast<float*>(v8_s + 2 * kT * D);
  float* vs_s = ks_s + 2 * kT;                 // int8: both [2][kT]

  auto src = [&](const T* t, int j) -> const T* {
    return keep(j) ? t + row(j) * D : nullptr;
  };
  auto stage = [&](int t, int buf) {
    if constexpr (kInt8) {
      load_rows_i8<D, kT, kDecodeThreads>(
          k8_s + buf * kT * D, [&](int r) { return src(k, t + r); }, k, tid);
      load_rows_i8<D, kT, kDecodeThreads>(
          v8_s + buf * kT * D, [&](int r) { return src(v, t + r); }, v, tid);
      // threads 0-63 the k scales of the tile's positions, 64-127 the v
      static_assert(kDecodeThreads == 2 * kT, "one thread a scale");
      const int r = tid & (kT - 1);
      const bool is_k = tid < kT;
      const float* sc = is_k ? k_scale : v_scale;
      const bool ok = keep(t + r);
      cp_async4((is_k ? ks_s : vs_s) + buf * kT + r,
                ok ? sc + row(t + r) : sc, ok ? 4 : 0);
    } else {
      load_rows<D, kT, kDecodeThreads>(
          k_s + buf * kT * LD, [&](int r) { return src(k, t + r); }, k, tid);
      load_rows<D, kT, kDecodeThreads>(
          v_s + buf * kT * LD, [&](int r) { return src(v, t + r); }, v, tid);
    }
  };

  load_rows<D, 16, kDecodeThreads>(
      q_s, [&](int r) { return r < G ? qb + (size_t)r * D : nullptr; }, qb,
      tid);
  if (t0 < t_end) stage(t0, 0);
  cp_async_commit();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = kMasked;
  l[0] = l[1] = 0.f;

  int buf = 0;
  for (; t0 < t_end; t0 += kT, buf ^= 1) {
    if (t0 + kT < t_end) stage(t0 + kT, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // the current tile (and q) have landed
    __syncthreads();
    const int tb = kInt8 ? 0 : buf * kT * LD;  // the bf16 tiles
    if constexpr (kInt8) {
      convert_rows_i8<D, kT, kDecodeThreads>(k_s, k8_s + buf * kT * D, tid);
      convert_rows_i8<D, kT, kDecodeThreads>(v_s, v8_s + buf * kT * D, tid);
      __syncthreads();
    }
    // this warp's 16 positions: which are kept (lanes 0-15 ask)
    const unsigned ok = __ballot_sync(
        0xffffffffu, lane < 16 && keep(t0 + warp * 16 + lane));
    if (ok != 0u) {  // warp-uniform
      const int kw = buf * kT + warp * 16;  // the warp's scales
      float s[2][4];
      scores<D, 16>(s, q_s, k_s + tb + warp * 16 * LD, lane);
      if constexpr (kInt8) scale_keys(s, ks_s + kw, lane);
      mask_keys(s, ok, lane);
      softmax_step(s, m, l, o, scale_log2);
      if constexpr (kInt8) scale_keys(s, vs_s + kw, lane);
      accumulate_pv<D, 16>(o, s, v_s + tb + warp * 16 * LD, lane);
    }
    __syncthreads();  // everyone is done with buf before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace attn_tile
