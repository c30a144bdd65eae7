// Flash attention forward with an optional padded prefix, for Hopper
// (sm_90a): bf16 on the tensor cores, f32 on the CUDA cores.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (Pallas _fa_kernel), extended with the serving engine's prefix mode:
// keys are `prefix_pad` rows of a padded, already-prefilled prefix (the
// first `prefix_len` valid) followed by the queries' own rows.  Query i
// sits at position prefix_len + i and keeps key j iff j < prefix_len and
// j > prefix_len + i - window (window), or j >= prefix_pad and
// j - prefix_pad <= i (causal) and j - prefix_pad > i - window (window).
// With prefix_pad = prefix_len = 0 that is _fa_kernel's mask; with
// prefix_pad = prefix_len = r * S it is shard r's rows of a sequence split
// over the model axis (ulysses_sp), windowed across the shard boundary.
//
// What bounds it: at the engine's prefill chunks on stablelm-3b (256
// queries over a 512-row padded prefix, H = KVH, d = 80) the bytes: q,
// the kept K/V rows and the output move once, and the 4*d flops per kept
// (row, key) pair take less time at the bf16 tensor-core peak than those
// bytes take at HBM rate.  Operations become the bound from roughly a
// thousand queries on, or sooner under GQA, where G query heads share each
// K/V row: recurrentgemma-9b's 2100-token prefill (16 heads over one kv
// head, d = 256, window 2048) needs 36 GFLOP.
//
// bf16, the served type (flash_mma_kernel): the tensor-core attention tile
// of ../../_attn_tile.cuh.
//   * one block of 4 warps per (64-query tile, head, batch); each warp owns
//     16 query rows, kept in shared memory and read by ldmatrix per k-step
//     (at d = 256 they would take 64 registers a lane beside the 128 of the
//     O accumulator);
//   * K/V tiles of 64 keys (32 at d > 128, for registers and for two
//     blocks an SM) of kv head h / G stream through a cp.async double
//     buffer; the q tiles are walked heaviest first (the last queries see
//     the most keys);
//   * key tiles that no row of the q tile can see (above the causal
//     diagonal, outside the window, or prefix padding) are never loaded
//     (Mask::tile_live), the loop stops at the last key the tile's last row
//     can see, a warp skips a loaded tile none of its rows can see, and a
//     tile that all of a warp's rows keep whole skips the per-element mask;
//   * within a live tile, rows that no query keeps -- rows >= T and prefix
//     padding prefix_len <= j < prefix_pad -- are zeros in shared memory
//     (copied with src-size 0, never read) and their scores are -inf, so a
//     NaN there cannot reach the output through 0 * V (ref.py's contract,
//     and the TPU kernel's zeroed out-of-bounds V rows);
//   * d must be a multiple of 16 up to 256 (the mma k-step and 16-byte
//     copies); the wrapper raises for any other d.
//
// f32 (flash_fwd_kernel), the check path of the serve phases' f32 logits
// comparison: an inner product on the CUDA cores, since mma has no f32
// operands.  One block per (q tile of 32 rows, head, batch) keeps its q
// tile in shared memory and streams K/V tiles of 32 keys; each lane scores
// one key for 8 query rows at a time, the online max/sum is a warp
// reduction, and P@V runs only over the keys that row keeps (a ballot), so
// masked or out-of-range V rows are never multiplied in.
//
// Softmax is online in f32 (running max m, sum l, accumulator acc per
// row); the output is acc / max(l, 1e-30) in q's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "_attn_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // query rows per block
constexpr int kKT = 32;                  // keys per tile (one per lane)
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

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

  // the prefix keys query i keeps: [prefix_len + i - window + 1,
  // prefix_len) under a window, else all prefix_len of them
  __device__ __forceinline__ bool keep(int i, int j) const {
    if (j < prefix_len) return window <= 0 || j > prefix_len + i - window;
    if (j < prefix_pad) return false;
    const int rel = j - prefix_pad;
    if (causal && rel > i) return false;
    if (window > 0 && rel <= i - window) return false;
    return true;
  }

  // Can any query row in [qlo, qhi] keep any key in [k0, k1]?
  __device__ __forceinline__ bool tile_live(int qlo, int qhi, int k0,
                                            int k1) const {
    // row qlo keeps the most prefix keys: its window reaches furthest back
    if (k0 < prefix_len &&
        (window <= 0 || min(k1, prefix_len - 1) > prefix_len + qlo - window))
      return true;
    const int lo = max(k0, prefix_pad);
    if (lo > k1) return false;
    if (causal && lo - prefix_pad > qhi) return false;
    if (window > 0 && k1 - prefix_pad <= qlo - window) return false;
    return true;
  }

  // Does every query row in [qlo, qhi] keep every key in [k0, k1]?
  __device__ __forceinline__ bool tile_full(int qlo, int qhi, int k0,
                                            int k1) const {
    if (k1 < prefix_len)
      return window <= 0 || k0 > prefix_len + qhi - window;
    if (k0 < prefix_pad) return false;
    if (causal && k1 - prefix_pad > qlo) return false;
    if (window > 0 && k0 - prefix_pad <= qhi - window) return false;
    return true;
  }

  // the key range [kbeg, kend) that the query rows [qlo, qhi] can see
  __device__ __forceinline__ int kend(int qhi, int T) const {
    return causal ? min(T, prefix_pad + qhi + 1) : T;
  }
  __device__ __forceinline__ int kbeg(int qlo) const {
    if (window <= 0) return 0;
    const int p0 = max(0, prefix_len + qlo - window + 1);
    return p0 < prefix_len ? p0 : prefix_pad + max(0, qlo - window + 1);
  }
};

// E = ceil(d / 32): head-dim elements per lane in the accumulator.
template <int E>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int T_, int H, int KVH, int d, Mask mask, float scale) {
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
    q_s[idx] = qi < S ? q[(((size_t)b * S + qi) * H + h) * d + e] : 0.f;
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
  // one its first row can see (window)
  const int kend = mask.kend(qhi, T_);
  for (int k0 = mask.kbeg(q0); k0 < kend; k0 += kKT) {
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
        kv = k[off];
        vv = v[off];
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
        out[(((size_t)b * S + qi) * H + h) * d + e] = acc[r][i] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

template <int D>
struct MmaTiles {
  static constexpr int kBQ = 64;                  // queries per block
  static constexpr int kBK = D > 128 ? 32 : 64;   // keys per K/V tile
  static constexpr int kLD = attn_tile::row_stride(D);
  // q tile + two K and two V tiles
  static constexpr size_t kSmem =
      (size_t)(kBQ + 4 * kBK) * kLD * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int T_, int H,
                 int KVH, Mask mask, float scale_log2) {
  using namespace attn_tile;
  using Tiles = MmaTiles<D>;
  constexpr int BQ = Tiles::kBQ, BK = Tiles::kBK, LD = Tiles::kLD;
  static_assert(D % 16 == 0 && D <= 256, "d: a multiple of 16 up to 256");
  static_assert(BQ == kWarps * 16, "one warp per 16 query rows");

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qhi = min(q0 + BQ, S) - 1;
  const int wlo = q0 + warp * 16;         // this warp's query rows
  const int whi = min(wlo + 15, S - 1);   // (none when whi < wlo)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * LD;     // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;  // [2][BK][LD]

  const __nv_bfloat16* kb = k + ((size_t)b * T_ * KVH + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T_ * KVH + kvh) * D;
  const size_t kv_row = (size_t)KVH * D;
  auto load_kv = [&](int k0, int buf) {
    // rows no query keeps stay zero: past T, and prefix padding
    auto row_ok = [&](int r) {
      const int j = k0 + r;
      return j < T_ && (j < mask.prefix_len || j >= mask.prefix_pad);
    };
    load_rows<D, BK, kWarps * 32>(
        k_s + buf * BK * LD,
        [&](int r) { return row_ok(r) ? kb + (k0 + r) * kv_row : nullptr; },
        kb, tid);
    load_rows<D, BK, kWarps * 32>(
        v_s + buf * BK * LD,
        [&](int r) { return row_ok(r) ? vb + (k0 + r) * kv_row : nullptr; },
        vb, tid);
  };
  const int kend = mask.kend(qhi, T_);
  auto next_live = [&](int k0) {
    while (k0 < kend && !mask.tile_live(q0, qhi, k0, min(k0 + BK, T_) - 1))
      k0 += BK;
    return k0;
  };

  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
  load_rows<D, BQ, kWarps * 32>(
      q_s,
      [&](int r) {
        return q0 + r < S ? qb + (size_t)(q0 + r) * H * D : nullptr;
      },
      qb, tid);
  int cur = next_live(mask.kbeg(q0));
  if (cur < kend) load_kv(cur, 0);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int g = lane >> 2, t = lane & 3;

  for (int buf = 0; cur < kend; buf ^= 1) {
    const int nxt = next_live(cur + BK);
    if (nxt < kend) load_kv(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // the current tile (and q) have landed
    __syncthreads();
    const int k1 = min(cur + BK, T_) - 1;
    if (wlo <= whi && mask.tile_live(wlo, whi, cur, k1)) {  // warp-uniform
      float s[BK / 8][4];
      scores<D, BK>(s, q_s + warp * 16 * LD, k_s + buf * BK * LD, lane);
      if (cur + BK > T_ || !mask.tile_full(wlo, whi, cur, cur + BK - 1)) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = wlo + g + (e >> 1) * 8;
            const int j = cur + n * 8 + 2 * t + (e & 1);
            if (!(j < T_ && mask.keep(qi, j))) s[n][e] = kMasked;
          }
      }
      softmax_step(s, m, l, o, scale_log2);
      accumulate_pv<D, BK>(o, s, v_s + buf * BK * LD, lane);
    }
    __syncthreads();  // everyone is done with buf before it is refilled
    cur = nxt;
  }
  cp_async_wait<0>();
  __syncthreads();  // q landed (other threads copied part of it), even if
                    // no tile was live

  // normalize, stage the warp's 16 rows in its own q rows, store 16 bytes
  // a lane
  __nv_bfloat16* stage = q_s + warp * 16 * LD;
  const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + c) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + c) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    if (wlo + r < S)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + wlo + r) * H + h) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
}

template <int D>
cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* out, int B,
                       int S, int T_, int H, int KVH, Mask mask, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = MmaTiles<D>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + MmaTiles<D>::kBQ - 1) / MmaTiles<D>::kBQ, H, B);
  flash_mma_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, out, S, T_, H, KVH, mask, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

#define FLASH_D_CASES(X)                                                   \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)  \
  X(192) X(208) X(224) X(240) X(256)

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int T_, int H, int KVH,
                        int d, Mask mask, float scale, cudaStream_t stream) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  switch (d) {
#define FLASH_MMA_CASE(D_) \
  case D_:                 \
    return launch_mma<D_>(qt, kt, vt, ot, B, S, T_, H, KVH, mask, scale, stream);
    FLASH_D_CASES(FLASH_MMA_CASE)
#undef FLASH_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

size_t smem_bf16(int d) {
  switch (d) {
#define FLASH_SMEM_CASE(D_) \
  case D_:                  \
    return MmaTiles<D_>::kSmem;
    FLASH_D_CASES(FLASH_SMEM_CASE)
#undef FLASH_SMEM_CASE
    default:
      return 0;
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores

size_t smem_f32(int d) {
  return (size_t)(kBQ * d + kKT * (d + 1) + kKT * d) * sizeof(float);
}

template <int E>
cudaError_t launch_e(const float* q, const float* k, const float* v,
                     float* out, int B, int S, int T_, int H, int KVH, int d,
                     Mask mask, float scale, cudaStream_t stream) {
  const size_t smem = smem_f32(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<E><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, out, S, T_, H, KVH, d, mask, scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int T_, int H, int KVH, int d, Mask mask,
                       float scale, cudaStream_t stream) {
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  auto* ot = static_cast<float*>(out);
  switch ((d + 31) / 32) {
#define FLASH_CASE(E_) \
  case E_:             \
    return launch_e<E_>(qt, kt, vt, ot, B, S, T_, H, KVH, d, mask, scale, stream);
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
    err = launch_f32(q, k, v, out, B, S, T, H, KVH, d, mask, scale, s);
  } else if (dtype == 1) {
    err = launch_bf16(q, k, v, out, B, S, T, H, KVH, d, mask, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block at head dim d (0: d not taken), for
// checking the wrapper's tile plan.
extern "C" int flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0) return d > 0 && d <= 256 ? (int)smem_f32(d) : 0;
  if (dtype == 1) return (int)smem_bf16(d);
  return 0;
}
