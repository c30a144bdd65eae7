// Paged decode attention for Hopper (sm_90a), f32 and bf16.
//
// Replaces repro/kernels/paged_attention/kernel.py:paged_decode_attention_fwd
// (Pallas _paged_kernel): one query token per sequence attends a
// block-paged KV pool [P, ps, KVH, d] through its page-table row, at the
// positions [start, len) with len = min(lengths[b], N * ps) and, under a
// window, start = max(0, lengths[b] - window).  The pool may be a view
// narrowed to KVH of the KVS heads its rows hold (the pointers then start
// at its first head): a shard reads the run of KV heads it needs in
// place, with no copy of the pool.
//
// What bounds it: bytes.  Each kept (token, kv head) is read once as a
// K row and a V row; at G = H/KVH query rows per kv head the kernel does
// 4*G*d flops per 4*d bytes (bf16), far below the card's ~295 flop/byte
// ridge.  So both kernels read only what they must: a block reads its own
// page_table[b, j / ps] (no gather copy), the G query rows of a kv head
// share every K/V row load, positions outside [start, len) and pages
// outside [0, P) are never read, so a stale page cannot poison the
// output, and a retired slot (table row all scratch page 0, stale length)
// reads only page 0 and stays finite.
//
// bf16, the served type (paged_mma_kernel): split-K over fixed chunks
// of 128 positions on the tensor-core decode tile of ../../_attn_tile.cuh.
// The grid is (ceil(N * ps / 128), KVH, B): the chunk length is fixed (a
// multiple of the 64-position tile), so the grid follows the page table's
// width and the wrapper never reads the lengths on the host; a block
// whose chunk misses [start, len) exits at once and writes nothing, and
// the combine (../../_attn_split.cuh) merges only the splits that overlap
// it.  A block stages its chunk's pool rows (page * ps + j % ps, or -1
// for a position it must not read) in shared memory once, then runs the
// decode kernels' tile loop (attn_tile::decode_tiles) over them: the G
// query heads of the kv head are the 16 rows of the A tile (G = 1 at
// stablelm-3b: the work is bound by bytes, and 16x the needed mma flops
// cost under a microsecond), warp w takes positions 16w .. 16w+15 of each
// 64-position tile, a position not read is a zero row (cp.async src-size
// 0) scored -inf, and the block merges its 4 warps and writes one partial
// per query head.  d must be a multiple of 16 up to 256 and G at most 16;
// the wrapper raises for anything else.

// f32, the serve phase's check path (paged_decode_kernel), on the CUDA
// cores: one block per (kv head, sequence) walks [start, length); four
// warps take tokens round robin, and within a warp the 32 lanes split the
// head dimension (lane + 32*i), so a K/V row is one coalesced load.  Each
// warp keeps an online max/sum and an f32 accumulator per query row; the
// warps' partial states are merged through shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "_attn_split.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E = ceil(d / 32): head-dim elements per lane.
template <int E>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int KVH, int KVS, int d, int ps, int N, int P,
                    int window, float scale) {
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
                     ? q[((size_t)b * H + kvh * G + g) * d + e]
                     : 0.f;
    }
  }

  int start, len;
  attn_tile::kept_range(lengths[b], N * ps, window, start, len);
  const int* row = page_table + (size_t)b * N;

  for (int j = start + warp; j < len; j += kWarps) {
    const int page = row[j / ps];
    if (page < 0 || page >= P) continue;  // never read outside the pool
    const size_t base = (((size_t)page * ps + (j % ps)) * KVS + kvh) * d;
    float kr[E], vr[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = lane + 32 * i;
      kr[i] = e < d ? k_pages[base + e] : 0.f;
      vr[i] = e < d ? v_pages[base + e] : 0.f;
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
    out[((size_t)b * H + kvh * G + g) * d + e] = o / fmaxf(lsum, 1e-30f);
  }
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int* table, const int* lengths, float* out,
                       int B, int H, int KVH, int KVS, int d, int ps, int N,
                       int P, int window, float scale, cudaStream_t stream) {
  const int G = H / KVH;
  const dim3 grid(KVH, B);
  const size_t smem = (size_t)(2 * kWarps * G + kWarps * G * d) * sizeof(float);
#define PAGED_CASE(E_)                                                    \
  case E_:                                                                \
    paged_decode_kernel<E_><<<grid, kWarps * 32, smem, stream>>>(         \
        q, k, v, table, lengths, out, H, KVH, KVS, d, ps, N, P, window,   \
        scale);                                                           \
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: split-K over fixed chunks

constexpr int kChunk = 128;    // positions per split (ops.py CHUNK)
constexpr int kMmaMaxG = 16;   // query heads per kv head: the A tile
static_assert(kChunk % attn_tile::kDecodeTile == 0, "whole K/V tiles");

template <int D>
constexpr size_t mma_smem_bytes() {
  // decode_tiles' q and K/V tiles, then the chunk's pool rows [kChunk]
  return attn_tile::decode_smem_bytes<D, __nv_bfloat16>() +
         kChunk * sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(attn_tile::kDecodeThreads)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k_pages,
                 const __nv_bfloat16* __restrict__ v_pages,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int H, int KVH, int KVS, int ps, int N, int P, int window,
                 int n_split, float scale_log2) {
  using namespace attn_tile;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  int start, len;
  kept_range(lengths[b], N * ps, window, start, len);
  const int j0 = split * kChunk;
  if (!chunk_live(j0, kChunk, start, len)) return;  // the combine skips it
  const int G = H / KVH;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* slot_s = reinterpret_cast<int*>(
      smem_raw + decode_smem_bytes<D, __nv_bfloat16>());
  // the chunk's pool rows: page * ps + j % ps, or -1 where position j is
  // not read (outside [start, len), or a page outside the pool)
  const int* pages = page_table + (size_t)b * N;
  for (int i = tid; i < kChunk; i += kDecodeThreads) {
    const int j = j0 + i;
    int slot = -1;
    if (j >= start && j < len) {
      const int page = pages[j / ps];
      if (page >= 0 && page < P) slot = page * ps + j % ps;
    }
    slot_s[i] = slot;
  }
  __syncthreads();

  auto keep = [&](int j) { return slot_s[j - j0] >= 0; };
  auto row = [&](int j) { return (long long)slot_s[j - j0] * KVS + kvh; };
  // from the first tile that reaches start (none where the window starts
  // at the length: the block then writes an empty partial)
  const int t0 = j0 + (max(start, j0) - j0) / kDecodeTile * kDecodeTile;
  float o[D / 8][4], m[2], l[2];
  decode_tiles<D, __nv_bfloat16>(
      smem_raw, q + ((size_t)b * H + (size_t)kvh * G) * D, G, k_pages,
      v_pages, nullptr, nullptr, keep, row, t0, min(j0 + kChunk, len),
      scale_log2, o, m, l);
  store_partial<D, kDecodeWarps>(o, m, l, reinterpret_cast<float*>(smem_raw),
                                 G, (size_t)b * H + (size_t)kvh * G, n_split,
                                 split, part_acc, part_ml, tid);
}

#define PAGED_D_CASES(X)                                                   \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)  \
  X(192) X(208) X(224) X(240) X(256)

template <int D>
cudaError_t launch_mma_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const int* table,
                         const int* lengths, float* part_acc, float* part_ml,
                         int B, int H, int KVH, int KVS, int ps, int N,
                         int P, int window, int n_split, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  const cudaError_t err = attn_tile::allow_smem(paged_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  paged_mma_kernel<D><<<dim3(n_split, KVH, B), attn_tile::kDecodeThreads,
                        smem, stream>>>(
      q, k, v, table, lengths, part_acc, part_ml, H, KVH, KVS, ps, N, P,
      window, n_split, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const int* table,
                       const int* lengths, float* part_acc, float* part_ml,
                       __nv_bfloat16* out, int B, int H, int KVH, int KVS,
                       int d, int ps, int N, int P, int window, int n_split,
                       float scale, cudaStream_t stream) {
  if (H / KVH > kMmaMaxG ||
      (long long)n_split != ((long long)N * ps + kChunk - 1) / kChunk)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (n_split > 0) {
    switch (d) {
#define PAGED_MMA_CASE(D_)                                                  \
  case D_:                                                                  \
    err = launch_mma_d<D_>(q, k, v, table, lengths, part_acc, part_ml, B, H, \
                           KVH, KVS, ps, N, P, window, n_split, scale,      \
                           stream);                                         \
    break;
      PAGED_D_CASES(PAGED_MMA_CASE)
#undef PAGED_MMA_CASE
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  attn_tile::decode_combine_kernel<__nv_bfloat16>
      <<<dim3(H, B), attn_tile::kCombineThreads, 0, stream>>>(
          part_acc, part_ml, out, H, d, n_split, lengths, N * ps, window,
          kChunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_attention_fwd(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* part_acc,
    void* part_ml, void* out, int B, int H, int KVH, int KVS, int d, int ps,
    int N, int P, int window, int n_split, float scale, void* stream) {
  if (B == 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || KVS < KVH)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* table = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = H / KVH > kMaxG
              ? cudaErrorInvalidValue
              : launch_f32(static_cast<const float*>(q),
                           static_cast<const float*>(k_pages),
                           static_cast<const float*>(v_pages), table, lens,
                           static_cast<float*>(out), B, H, KVH, KVS, d, ps,
                           N, P, window, scale, s);
  } else if (dtype == 1) {
    err = launch_mma(static_cast<const __nv_bfloat16*>(q),
                     static_cast<const __nv_bfloat16*>(k_pages),
                     static_cast<const __nv_bfloat16*>(v_pages), table, lens,
                     static_cast<float*>(part_acc),
                     static_cast<float*>(part_ml),
                     static_cast<__nv_bfloat16*>(out), B, H, KVH, KVS, d,
                     ps, N, P, window, n_split, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
