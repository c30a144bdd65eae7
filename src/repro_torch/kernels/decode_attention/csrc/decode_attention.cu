// Decode attention over a contiguous or ring KV cache for Hopper
// (sm_90a): q in f32 or bf16, K/V in q's type or int8 with f32 scales.
//
// Replaces repro/kernels/decode_attention/kernel.py:decode_attention_fwd
// (Pallas _dec_kernel) and :decode_attention_int8_fwd (_dec_int8_kernel):
// one query token per sequence, q [B,1,H,d], attends k/v [B,C,KVH,d]
// where valid[b, j] is set (a partly filled cache or a ring buffer).
// Query head h reads kv head h / G (G = H / KVH).  Output is q's type,
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
// split.  The wrapper sizes the chunks for about one block per SM, in
// multiples of the 64-position tile (ops.py:split_plan).  A slot with
// valid[b, j] unset is never read: its rows are copied with src-size 0
// (zeros in shared memory) and its scores are -inf, so a NaN in an
// unwritten or stale slot cannot poison the output, and a 16-slot group
// with no valid slot is skipped by its warp.  d must be a multiple of 16
// up to 256; the wrapper raises for any other d.
//
// f32 and int8 (decode_partial_kernel), on the CUDA cores: inside a block
// the G query heads share every K/V tile: for each tile of 32 positions,
// warps take rows round robin, lanes split the head dimension (a
// coalesced row load), the row's V goes to shared memory and its G scores
// come from warp reductions against q in shared memory; one warp per query
// head then updates the online softmax over the tile, and every thread
// folds the tile into its (head, dim) slice of the accumulator.  Rows
// with valid[b, j] unset are never loaded: their V row in shared memory
// is zero and their probability an explicit 0.  The int8 entry point is
// the same kernel reading int8 rows and one f32 scale per (position,
// head), dequantized in registers: the cache is read as int8.  Its chunks
// aim at two blocks per SM, in multiples of its 32-position tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "_attn_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;        // positions per tile: one per lane in phase 2
constexpr int kMaxG = 16;     // query heads per kv head
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
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
                      int d, int chunk, int n_split, float scale) {
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
        const size_t row = ((size_t)b * C + j) * KVH + kvh;
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

// Merge the n_split chunks' (m, l, acc) of one (head, b).  A chunk that
// saw no valid row holds m = -1e30, l = 0, acc = 0 and weighs nothing.
template <typename Tq>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, Tq* __restrict__ out,
                      int H, int d, int n_split) {
  const size_t row = (size_t)blockIdx.y * H + blockIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int e = threadIdx.x; e < d; e += kThreads) {
    float lsum = 0.f, o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(ml[2 * s] - mx);
      lsum += ml[2 * s + 1] * c;
      o += part_acc[(row * n_split + s) * d + e] * c;
    }
    out[row * d + e] = from_f<Tq>(o / fmaxf(lsum, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// dense bf16 on the tensor cores

constexpr int kMmaTile = 64;   // cache positions per block tile: 16 a warp

template <int D>
constexpr size_t mma_smem_bytes() {
  // q [16][LD] + two K and two V tiles [kMmaTile][LD], bf16; the merge
  // reuses the K/V tiles for 4 warps' O [16][D] in f32
  return (size_t)(16 + 4 * kMmaTile) * attn_tile::row_stride(D) *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int C, int H, int KVH, int chunk, int n_split,
                  float scale_log2) {
  using namespace attn_tile;
  constexpr int LD = row_stride(D);
  static_assert(D % 16 == 0 && D <= 256, "d: a multiple of 16 up to 256");
  static_assert(kMmaTile == kWarps * 16, "16 positions a warp");
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = split * chunk;
  const int j1 = min(C, j0 + chunk);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + 16 * LD;             // [2][kMmaTile][LD]
  __nv_bfloat16* v_s = k_s + 2 * kMmaTile * LD;   // [2][kMmaTile][LD]

  const uint8_t* vb = valid + (size_t)b * C;
  const size_t row0 = (size_t)b * C * KVH + kvh;  // K/V row of slot 0
  auto slot_ok = [&](int j) { return j < j1 && vb[j] != 0; };
  auto load_tile = [&](int t0, int buf) {
    load_rows<D, kMmaTile, kThreads>(
        k_s + buf * kMmaTile * LD,
        [&](int r) {
          const int j = t0 + r;
          return slot_ok(j) ? k + (row0 + (size_t)j * KVH) * D : nullptr;
        },
        k, tid);
    load_rows<D, kMmaTile, kThreads>(
        v_s + buf * kMmaTile * LD,
        [&](int r) {
          const int j = t0 + r;
          return slot_ok(j) ? v + (row0 + (size_t)j * KVH) * D : nullptr;
        },
        v, tid);
  };

  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  load_rows<D, 16, kThreads>(
      q_s, [&](int r) { return r < G ? qb + (size_t)r * D : nullptr; }, qb,
      tid);
  if (j0 < j1) load_tile(j0, 0);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  int buf = 0;
  for (int t0 = j0; t0 < j1; t0 += kMmaTile, buf ^= 1) {
    if (t0 + kMmaTile < j1) load_tile(t0 + kMmaTile, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // the current tile (and q) have landed
    __syncthreads();
    // this warp's 16 slots: which are valid (lanes 0-15 ask)
    const int jw = t0 + warp * 16;
    const unsigned ok =
        __ballot_sync(0xffffffffu, lane < 16 && slot_ok(jw + lane));
    if (ok != 0u) {  // warp-uniform
      float s[2][4];
      scores<D, 16>(s, q_s, k_s + (buf * kMmaTile + warp * 16) * LD, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((ok >> (n * 8 + 2 * t + (e & 1))) & 1u)) s[n][e] = kMasked;
      softmax_step(s, m, l, o, scale_log2);
      accumulate_pv<D, 16>(o, s, v_s + (buf * kMmaTile + warp * 16) * LD,
                           lane);
    }
    __syncthreads();  // everyone is done with buf before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the 4 warps' (m, l, O) through shared memory (over the K/V
  // tiles), then write this split's partial per query head
  float* o_s = reinterpret_cast<float*>(k_s);   // [kWarps][16][D]
  float* ml_s = o_s + kWarps * 16 * D;          // [kWarps][16][2]
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
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int r = idx / D;
    const int e = idx - r * D;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[w * 32 + 2 * r]);
    float lsum = 0.f, acc = 0.f;
    if (mx != kMasked) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(ml_s[w * 32 + 2 * r] - mx);
        lsum += ml_s[w * 32 + 2 * r + 1] * c;
        acc += o_s[(w * 16 + r) * D + e] * c;
      }
    }
    const size_t prow = ((size_t)b * H + (size_t)kvh * G + r) * n_split + split;
    part_acc[prow * D + e] = acc;
    if (e == 0) {
      // the combine kernel works in natural-log units; a split that saw
      // no valid slot weighs nothing (m = -1e30, l = 0, acc = 0)
      part_ml[prow * 2] = mx != kMasked ? mx * kLn2 : kNegInf;
      part_ml[prow * 2 + 1] = lsum;
    }
  }
}

#define DECODE_D_CASES(X)                                                  \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)  \
  X(192) X(208) X(224) X(240) X(256)

template <int D>
cudaError_t launch_mma_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, const uint8_t* valid,
                         float* part_acc, float* part_ml, int B, int C, int H,
                         int KVH, int chunk, int n_split, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_mma_kernel<D><<<dim3(n_split, KVH, B), kThreads, smem, stream>>>(
      q, k, v, valid, part_acc, part_ml, C, H, KVH, chunk, n_split,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid;
  float *part_acc, *part_ml;
  void* out;
  int B, C, H, KVH, d, chunk, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename Tq, typename Tkv, bool kQuant, int E>
cudaError_t launch_e(const Args& a) {
  const int G = a.H / a.KVH;
  const size_t smem = smem_bytes(G, a.d);
  auto kern = decode_partial_kernel<Tq, Tkv, kQuant, E>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(a.n_split, a.KVH, a.B), kThreads, smem, a.stream>>>(
      static_cast<const Tq*>(a.q), static_cast<const Tkv*>(a.k),
      static_cast<const Tkv*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const uint8_t*>(a.valid), a.part_acc, a.part_ml, a.C, a.H,
      a.KVH, a.d, a.chunk, a.n_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<Tq><<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<Tq*>(a.out), a.H, a.d, a.n_split);
  return cudaGetLastError();
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

cudaError_t launch_mma(const Args& a) {
  const auto* q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* k = static_cast<const __nv_bfloat16*>(a.k);
  const auto* v = static_cast<const __nv_bfloat16*>(a.v);
  const auto* valid = static_cast<const uint8_t*>(a.valid);
  cudaError_t err;
  switch (a.d) {
#define DECODE_MMA_CASE(D_)                                                 \
  case D_:                                                                  \
    err = launch_mma_d<D_>(q, k, v, valid, a.part_acc, a.part_ml, a.B, a.C, \
                           a.H, a.KVH, a.chunk, a.n_split, a.scale,         \
                           a.stream);                                       \
    break;
    DECODE_D_CASES(DECODE_MMA_CASE)
#undef DECODE_MMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_combine_kernel<__nv_bfloat16>
      <<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
          a.part_acc, a.part_ml, static_cast<__nv_bfloat16*>(a.out), a.H,
          a.d, a.n_split);
  return cudaGetLastError();
}

bool bad_args(const Args& a) {
  return a.KVH <= 0 || a.H % a.KVH != 0 || a.H / a.KVH > kMaxG ||
         a.chunk <= 0 || a.chunk % kT != 0 || a.n_split <= 0 ||
         (long long)a.chunk * a.n_split < a.C;
}

}  // namespace

extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* valid,
                                    void* part_acc, void* part_ml, void* out,
                                    int B, int C, int H, int KVH, int d,
                                    int chunk, int n_split, float scale,
                                    void* stream) {
  const Args a{q, k, v, nullptr, nullptr, valid,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               out, B, C, H, KVH, d, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (B == 0 || C == 0) return 0;
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float, false>(a);
  } else if (dtype == 1) {
    err = a.chunk % kMmaTile != 0 ? cudaErrorInvalidValue : launch_mma(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int decode_attention_int8_fwd(
    int dtype, const void* q, const void* k_q, const void* v_q,
    const void* k_scale, const void* v_scale, const void* valid,
    void* part_acc, void* part_ml, void* out, int B, int C, int H, int KVH,
    int d, int chunk, int n_split, float scale, void* stream) {
  const Args a{q, k_q, v_q, k_scale, v_scale, valid,
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               out, B, C, H, KVH, d, chunk, n_split, scale,
               static_cast<cudaStream_t>(stream)};
  if (B == 0 || C == 0) return 0;
  if (bad_args(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, int8_t, true>(a);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, int8_t, true>(a);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
