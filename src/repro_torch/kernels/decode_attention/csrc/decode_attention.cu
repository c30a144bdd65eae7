// Decode attention over a contiguous or ring KV cache for Hopper
// (sm_90a): q in f32 or bf16, K/V in q's type or int8 with f32 scales.
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_fwd
// (Pallas _dec_kernel) and :decode_attention_int8_fwd (_dec_int8_kernel):
// one query token per sequence, q [B,1,H,d], attends k/v [B,C,KVH,d]
// where valid[b, j] is set (a partly filled cache or a ring buffer).
// Query head h reads kv head h / G (G = H / KVH).  The cache (and its
// scales) may be a view narrowed to KVH of the KVS heads its rows hold,
// the pointers then at its first head: a shard reads the run of KV heads
// it needs in place, with no copy of the cache.  Output is q's type,
// accumulated in f32.
//
// What bounds it: bytes.  Each valid K/V row is read once, and the G
// query heads of a kv head do 4*G*d flops on it, far below the card's
// flop/byte ridge.  The TPU kernel's grid (B, KVH, n_kv) ran the cache
// blocks in order, carrying the softmax state in scratch.  Here blocks
// run in parallel, and at recurrentgemma's shape (B = 8, KVH = 1) one
// block per (b, kv head) would fill 8 of 132 SMs, so the design is
// split-K (flash-decoding): a first kernel gives each (chunk of the
// cache, kv head, b) a block, which writes its partial (max m, sum l, f32
// accumulator) per query head to a workspace; a second kernel merges the
// chunks' partials per (head, b).  The combine stays a kernel of its own
// (a kernel boundary orders the blocks' writes without atomics); with one
// block per SM its partials are 2.1 MB at recurrentgemma's shape, half
// what two blocks per SM wrote.
//
// Dense bf16, the served type (decode_mma_kernel): the tensor-core
// attention tile of ../../_attn_tile.cuh.  The G query heads of a kv head
// are the 16 rows of the A tile (G = 16 exactly at recurrentgemma; for
// G < 16 the rows past G are zero and dropped).  The block stages tiles of
// 64 cache positions through a cp.async double buffer; warp w takes
// positions 16w .. 16w+15 of each tile and runs S = Q K^T and O += P V
// with mma over them, keeping its own (m, l, O).  At the end the block
// merges its 4 warps' states in shared memory and writes one partial per
// split (../../_attn_split.cuh, which also holds the combine kernel).  The
// wrapper sizes the chunks for about one block per SM, in multiples of
// the 64-position tile (ops.py:split_plan).  A slot with valid[b, j]
// unset is never read: its rows are copied with src-size 0 (zeros in
// shared memory) and its scores are -inf, so a NaN in an unwritten or
// stale slot cannot poison the output, and a 16-slot group with no valid
// slot is skipped by its warp.  d must be a multiple of 16 up to 256; the
// wrapper raises for any other d.
//
// int8 K/V under bf16 q, the served int8 path (decode_int8_mma_kernel):
// the same tile, split plan and merge.  A tile's int8 rows (d bytes each)
// and their scales are staged by cp.async in turns, as bytes, then
// converted to one bf16 tile in shared memory; the conversion is exact
// (|x| <= 127 fits bf16's significand), so the scales stay out of the
// operands: k_scale multiplies S's columns before the softmax, v_scale
// multiplies P before it is rounded to bf16 for P V (the dense path's one
// rounding), and l sums the unscaled P.  An invalid slot's scales are
// never loaded (zeros arrive), so a NaN scale there cannot reach the
// output through 0 * NaN.  At d = 256 a block holds 139 KB of shared
// memory: one block an SM, as the plan assumes.  Both kernels run one
// block body over the tile's loop (attn_tile::decode_tiles), which the
// paged kernel shares; they differ only in the K/V type.
//
// f32 q, dense or int8 K/V (decode_partial_kernel), the serve phases'
// check path, on the CUDA cores: inside a block the G query heads share
// every K/V tile: for each tile of 32 positions, warps take rows round
// robin, lanes split the head dimension (a coalesced row load), the row's
// V goes to shared memory and its G scores come from warp reductions
// against q in shared memory; one warp per query head then updates the
// online softmax over the tile, and every thread folds the tile into its
// (head, dim) slice of the accumulator.  Rows with valid[b, j] unset are
// never loaded: their V row in shared memory is zero and their
// probability an explicit 0.  int8 rows and their f32 scale per
// (position, head) are dequantized in registers: the cache is read as
// int8.  Its chunks aim at two blocks per SM, in multiples of its
// 32-position tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "_attn_split.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;        // positions per tile: one per lane in phase 2
constexpr int kMaxG = 16;     // query heads per kv head
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
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

size_t smem_bytes(int G, int d) {
  // q [G][d], V tile [kT][d], p [G][kT], m/l/alpha [G], ok [kT]
  return (size_t)(G * d + kT * d + G * kT + 3 * G + kT) * sizeof(float);
}

// E = ceil(d / 32): head-dim elements per lane in phase 1.
template <typename Tq, typename Tkv, bool kQuant, int E>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const Tq* __restrict__ q, const Tkv* __restrict__ k,
                      const Tkv* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int C, int H, int KVH,
                      int KVS, int d, int chunk, int n_split, float scale) {
  static_assert(kT == 32, "phase 2 gives each lane one position of a tile");
  constexpr int KE = (E * 32 + kThreads - 1) / kThreads;  // dims per thread
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j0 = split * chunk;
  const int j1 = min(C, j0 + chunk);

  extern __shared__ float smem[];
  float* q_s = smem;               // [G][d]
  float* v_s = q_s + G * d;        // [kT][d]
  float* p_s = v_s + kT * d;       // [G][kT]: scores, then probabilities
  float* m_s = p_s + G * kT;       // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] this tile's rescale of acc
  int* ok_s = reinterpret_cast<int*>(a_s + G);  // [kT]

  const Tq* qb = q + ((size_t)b * H + (size_t)kvh * G) * d;
  for (int idx = tid; idx < G * d; idx += kThreads) q_s[idx] = to_f(qb[idx]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxG][KE];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < KE; ++c) acc[g][c] = 0.f;
  __syncthreads();

  for (int t0 = j0; t0 < j1; t0 += kT) {
    // phase 1: the tile's scores and V rows; warp w takes rows w, w+4, ...
    for (int jj = warp; jj < kT; jj += kWarps) {
      const int j = t0 + jj;
      const bool ok = j < j1 && valid[(size_t)b * C + j] != 0;  // warp-uniform
      if (ok) {
        const size_t row = ((size_t)b * C + j) * KVS + kvh;
        const float ks = kQuant ? k_scale[row] : 1.f;
        const float vs = kQuant ? v_scale[row] : 1.f;
        const Tkv* kr_p = k + row * d;
        const Tkv* vr_p = v + row * d;
        float kr[E];
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int e = lane + 32 * i;
          kr[i] = e < d ? to_f(kr_p[e]) * ks : 0.f;
          if (e < d) v_s[jj * d + e] = to_f(vr_p[e]) * vs;
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {  // uniform across the warp
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < E; ++i) {
              const int e = lane + 32 * i;
              if (e < d) part += q_s[g * d + e] * kr[i];
            }
            const float s = warp_sum(part) * scale;
            if (lane == 0) p_s[g * kT + jj] = s;
          }
        }
      } else {
        for (int e = lane; e < d; e += 32) v_s[jj * d + e] = 0.f;
      }
      if (lane == 0) ok_s[jj] = ok ? 1 : 0;
    }
    __syncthreads();

    // phase 2: online softmax over the tile, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      const bool ok = ok_s[lane] != 0;
      const float s = ok ? p_s[g * kT + lane] : kNegInf;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float psum = warp_sum(p);
      p_s[g * kT + lane] = p;
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // phase 3: acc[g][e] = acc[g][e] * alpha[g] + sum_jj p[g][jj] v[jj][e]
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float alpha = a_s[g];
#pragma unroll
        for (int c = 0; c < KE; ++c) acc[g][c] *= alpha;
      }
    }
    for (int jj = 0; jj < kT; ++jj) {
      if (ok_s[jj] == 0) continue;  // uniform across the block
      float vv[KE];
#pragma unroll
      for (int c = 0; c < KE; ++c) {
        const int e = tid + kThreads * c;
        vv[c] = e < d ? v_s[jj * d + e] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = p_s[g * kT + jj];
#pragma unroll
          for (int c = 0; c < KE; ++c) acc[g][c] += p * vv[c];
        }
      }
    }
    __syncthreads();  // the next tile overwrites v_s, p_s and ok_s
  }

  // this chunk's partial state per query head
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const size_t prow =
          ((size_t)b * H + (size_t)kvh * G + g) * n_split + split;
#pragma unroll
      for (int c = 0; c < KE; ++c) {
        const int e = tid + kThreads * c;
        if (e < d) part_acc[prow * d + e] = acc[g][c];
      }
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    const size_t prow =
        ((size_t)b * H + (size_t)kvh * G + g) * n_split + split;
    part_ml[prow * 2] = m_s[g];
    part_ml[prow * 2 + 1] = l_s[g];
  }
}

// ---------------------------------------------------------------------------
// bf16 q on the tensor cores: dense bf16 and int8 K/V, one block body
// over attn_tile::decode_tiles

// Block (split, kv head, b) attends the positions [split * chunk,
// min(C, split * chunk + chunk)) of row b with valid[b, j] set, and
// writes its partial per query head.
template <int D, typename T>
__device__ __forceinline__ void decode_block(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const uint8_t* __restrict__ valid,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int C, int H,
    int KVH, int KVS, int chunk, int n_split, float scale_log2) {
  using namespace attn_tile;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int j0 = split * chunk;
  const int j1 = min(C, j0 + chunk);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const uint8_t* vb = valid + (size_t)b * C;
  const long long row0 = (long long)b * C * KVS + kvh;  // row of slot 0
  auto keep = [&](int j) { return j < j1 && vb[j] != 0; };
  auto row = [&](int j) { return row0 + (long long)j * KVS; };
  float o[D / 8][4], m[2], l[2];
  decode_tiles<D, T>(smem_raw, q + ((size_t)b * H + (size_t)kvh * G) * D,
                     G, k, v, k_scale, v_scale, keep, row, j0, j1,
                     scale_log2, o, m, l);
  store_partial<D, kDecodeWarps>(o, m, l, reinterpret_cast<float*>(smem_raw),
                                 G, (size_t)b * H + (size_t)kvh * G, n_split,
                                 split, part_acc, part_ml, threadIdx.x);
}

template <int D>
__global__ void __launch_bounds__(attn_tile::kDecodeThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int C, int H, int KVH, int KVS, int chunk, int n_split,
                  float scale_log2) {
  decode_block<D>(q, k, v, k_scale, v_scale, valid, part_acc, part_ml, C, H,
                  KVH, KVS, chunk, n_split, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(attn_tile::kDecodeThreads)
decode_int8_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int C, int H, int KVH,
                       int KVS, int chunk, int n_split, float scale_log2) {
  decode_block<D>(q, k, v, k_scale, v_scale, valid, part_acc, part_ml, C, H,
                  KVH, KVS, chunk, n_split, scale_log2);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid;
  float *part_acc, *part_ml;
  void* out;
  int B, C, H, KVH, KVS, d, chunk, n_split;
  float scale;
  cudaStream_t stream;
};

#define DECODE_D_CASES(X)                                                  \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)  \
  X(192) X(208) X(224) X(240) X(256)

// Merge the splits' partials into out (every split wrote one).  A null
// out (the partial entries) skips it: the caller merges the partials of
// several caches, e.g. the shards of a sequence-split one.
template <typename Tq>
cudaError_t combine(const Args& a) {
  attn_tile::decode_combine_kernel<Tq>
      <<<dim3(a.H, a.B), attn_tile::kCombineThreads, 0, a.stream>>>(
          a.part_acc, a.part_ml, static_cast<Tq*>(a.out), a.H, a.d,
          a.n_split, nullptr, 0, 0, 1);
  return cudaGetLastError();
}

template <int D, typename T>
auto mma_kernel() {
  if constexpr (std::is_same<T, int8_t>::value)
    return decode_int8_mma_kernel<D>;
  else
    return decode_mma_kernel<D>;
}

template <int D, typename T>
cudaError_t launch_mma_d(const Args& a) {
  constexpr size_t smem = attn_tile::decode_smem_bytes<D, T>();
  const auto kern = mma_kernel<D, T>();
  const cudaError_t err = attn_tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.n_split, a.KVH, a.B), attn_tile::kDecodeThreads, smem,
         a.stream>>>(static_cast<const __nv_bfloat16*>(a.q),
                     static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                     static_cast<const float*>(a.k_scale),
                     static_cast<const float*>(a.v_scale),
                     static_cast<const uint8_t*>(a.valid), a.part_acc,
                     a.part_ml, a.C, a.H, a.KVH, a.KVS, a.chunk, a.n_split,
                     a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv, bool kQuant, int E>
cudaError_t launch_e(const Args& a) {
  const int G = a.H / a.KVH;
  const size_t smem = smem_bytes(G, a.d);
  auto kern = decode_partial_kernel<Tq, Tkv, kQuant, E>;
  cudaError_t err = attn_tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.n_split, a.KVH, a.B), kThreads, smem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tkv*>(a.k),
      static_cast<const Tkv*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const uint8_t*>(a.valid), a.part_acc, a.part_ml, a.C, a.H,
      a.KVH, a.KVS, a.d, a.chunk, a.n_split, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.out == nullptr) return err;
  return combine<Tq>(a);
}

template <typename Tq, typename Tkv, bool kQuant>
cudaError_t launch(const Args& a) {
  switch ((a.d + 31) / 32) {
#define DECODE_CASE(E_) \
  case E_:              \
    return launch_e<Tq, Tkv, kQuant, E_>(a);
    DECODE_CASE(1)
    DECODE_CASE(2)
    DECODE_CASE(3)
    DECODE_CASE(4)
    DECODE_CASE(5)
    DECODE_CASE(6)
    DECODE_CASE(7)
    DECODE_CASE(8)
#undef DECODE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mma(const Args& a) {
  cudaError_t err;
  switch (a.d) {
#define DECODE_MMA_CASE(D_)        \
  case D_:                         \
    err = launch_mma_d<D_, T>(a);  \
    break;
    DECODE_D_CASES(DECODE_MMA_CASE)
#undef DECODE_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.out == nullptr) return err;
  return combine<__nv_bfloat16>(a);
}

bool bad_args(const Args& a) {
  return a.KVH <= 0 || a.H % a.KVH != 0 || a.H / a.KVH > kMaxG ||
         a.KVS < a.KVH ||
         a.chunk <= 0 || a.chunk % kT != 0 || a.n_split <= 0 ||
         (long long)a.chunk * a.n_split < a.C;
}

}  // namespace

// The entries: with out null (the *_partial_fwd entries) they stop after
// the partial kernel and leave part_acc [B, H, n_split, d] and part_ml
// [B, H, n_split, 2] (m in natural-log units of the scaled scores, l) to
// the caller, who merges them with decode_combine_fwd.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* part_acc, void* part_ml, void* out,
                                    int B, int C, int H, int KVH, int KVS,
                                    int d, int chunk, int n_split,
                                    float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, valid,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               out, B, C, H, KVH, KVS, d, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (B == 0 || C == 0) return 0;
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float, false>(a);
  } else if (dtype == 1) {
    err = a.chunk % attn_tile::kDecodeTile != 0
              ? cudaErrorInvalidValue
              : launch_mma<__nv_bfloat16>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int decode_attention_int8_fwd(
    int dtype, const void* q, const void* k_q, const void* v_q,
    const void* k_scale, const void* v_scale, const void* valid,
    void* part_acc, void* part_ml, void* out, int B, int C, int H, int KVH,
    int KVS, int d, int chunk, int n_split, float scale, void* stream) {
  const Args a{q, k_q, v_q, k_scale, v_scale, valid,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               out, B, C, H, KVH, KVS, d, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (B == 0 || C == 0) return 0;
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, int8_t, true>(a);
  } else if (dtype == 1) {
    err = a.chunk % attn_tile::kDecodeTile != 0
              ? cudaErrorInvalidValue
              : launch_mma<int8_t>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int decode_attention_partial_fwd(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const void* valid, void* part_acc,
                                            void* part_ml, int B, int C,
                                            int H, int KVH, int KVS, int d,
                                            int chunk, int n_split,
                                            float scale, void* stream) {
  return decode_attention_fwd(dtype, q, k, v, valid, part_acc, part_ml,
                              nullptr, B, C, H, KVH, KVS, d, chunk, n_split,
                              scale, stream);
}

extern "C" int decode_attention_int8_partial_fwd(
    int dtype, const void* q, const void* k_q, const void* v_q,
    const void* k_scale, const void* v_scale, const void* valid,
    void* part_acc, void* part_ml, int B, int C, int H, int KVH, int KVS,
    int d, int chunk, int n_split, float scale, void* stream) {
  return decode_attention_int8_fwd(dtype, q, k_q, v_q, k_scale, v_scale,
                                   valid, part_acc, part_ml, nullptr, B, C, H,
                                   KVH, KVS, d, chunk, n_split, scale, stream);
}

// Merge n_split partials per (b, head) -- the splits of one cache or the
// stacked splits of several -- into out [B, H, d] of q's type (dtype 0
// f32, 1 bf16): the combine kernel of ../../_attn_split.cuh over every
// split.
extern "C" int decode_combine_fwd(int dtype, const void* part_acc,
                                  const void* part_ml, void* out, int B,
                                  int H, int d, int n_split, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (n_split <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.part_acc = const_cast<float*>(static_cast<const float*>(part_acc));
  a.part_ml = const_cast<float*>(static_cast<const float*>(part_ml));
  a.out = out;
  a.B = B;
  a.H = H;
  a.d = d;
  a.n_split = n_split;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(combine<float>(a));
  if (dtype == 1) return static_cast<int>(combine<__nv_bfloat16>(a));
  return static_cast<int>(cudaErrorInvalidValue);
}
