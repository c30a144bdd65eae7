// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32 in and out.
//
// Replaces repro/kernels/ssd/kernel.py:ssd_chunk_scan_fwd (Pallas
// _ssd_kernel).  For each (batch, head), over the sequence in chunks of kQ
// steps, with da the per-step log decay:
//
//   y_i   = sum_{j<=i} L[i,j] (C_i . B_j) xdt_j + exp(cum_i) (C_i . h_in)
//   h_out = exp(total) h_in + sum_j w_j B_j^T xdt_j
//   L[i,j] = exp(sum_{j<k<=i} da_k),  cum_i = sum_{k<=i} da_k,
//   w_j = exp(sum_{k>j} da_k),        total = sum_k da_k
//
// Inputs: x [b,S,H,P], dt [b,S,H] and a_log [H] f32 (da = dt A with A =
// -exp(a_log), and xdt = x dt, are formed here as a chunk is loaded, each
// rounded once, as the reference wrapper forms them); B, C [b,S,N] f32,
// shared by all heads; h0 [b,H,N,P] f32 or null (zeros).
// Outputs: y [b,S,H,P] f32 and the final state hout [b,H,N,P] f32.
// Scratch, allocated by the wrapper: the chunk states [b,nc,H,N,P], the
// chunks' total log decays [b,nc,H] and C.B^T [b,nc,kQ,kQ].
//
// What bounds it: bytes, at the model's decay.  At the serving shape
// (S = 2048, H = 80, P = 64, N = 128) each input read once and each output
// written once is ~90 MB, 27 us at 3.35 TB/s.  Every product of the
// chunked form is ~5.7 GFLOP (85 us at the 67 TFLOP/s f32 peak of the CUDA
// cores), but with da ~ -2.2 a step a decay weight underflows to 0 in
// float32 past ~47 steps, and the products whose weight is not 0 are
// ~1.1 GFLOP (16 us; chip_smoke.py's ssd_needed_flops counts them from
// each run's decays).
//
// Design: the Mamba-2 chunked decomposition, in three launches on the
// caller's stream, each parallel over chunks and heads (not one block per
// (batch, head) through every chunk in order: 80 blocks on 132 SMs at
// b = 1):
//   1. ssd_state_mma_kernel, a block per (head, chunk): the chunk's own
//      state B^T (w o xdt) [N,P] from zero, and the chunk's total log
//      decay; kRowTiles more blocks per chunk form C.B^T once for all heads
//      (not again in every head);
//   2. ssd_pass_kernel, a thread per 4 state entries of every head: the
//      sequential pass over chunks, h_in[c+1] = exp(total[c]) h_in[c] +
//      state[c] from h0 (or zeros), written over chunk c's state, and the
//      final state;
//   3. ssd_out_mma_kernel, a block per (head, chunk):
//      y = exp(cum) o (C.h_in) + (L o C.B^T).xdt, one accumulator over both
//      products.
// At b = 1, S = 2048 that is 1,312, 640 and 1,280 blocks, two on an SM, so
// one block's loads overlap the other's math.  The chunk is kQ = 128 steps:
// the chunk states round-trip 42 MB (84 MB at 64, with less of the causal
// product; 21 MB at 256, with more).
//
// Decays that underflow to 0 are skipped, exactly: their products add
// zeros.  With the model's decay (da ~ -2 a step) the weights w_j of all
// but the chunk's last ~50 steps are 0, so the state kernel loads and
// multiplies only the steps from the first nonzero weight on (in groups
// of 8); exp(cum_i) is 0 past the first ~50 rows, so the output kernel
// loads C and forms C.h_in only for rows (and warps) where it is not; L
// is 0 far below the diagonal, so each warp's G.xdt starts at the first
// 8-column group where its rows' G has a nonzero; and exp(total) is 0, so
// the pass leaves every chunk state in place as the next chunk's h_in.
//
// Products on the tensor cores in 3xTF32: each f32 operand x is split into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: to nearest, ties away from
// zero), and mma.sync.m16n8k8 adds lo.hi' + hi.lo' + hi.hi' in f32: ~f32
// accuracy (the dropped lo.lo' is 2^-22 of the product), where one TF32
// product keeps ~3 decimal digits.  A warp owns a 32x32 output tile (2x4
// fragments of 16x8); operands are read from shared memory with strides
// that put a fragment's 32 reads in 32 banks (rows of 4 mod 32 floats
// where the fragment walks a row, 8 mod 32 where it walks a column).
// Tiles arrive by 16-byte cp.async, zero-filled past S, N and P.
//
// Numerics: every decay is the exponential of
// a segment sum -- w's and cum's are scans of the chunk's da, and L's are
// run down each column from j + 1 in blocks of 8 rows, each a sum of
// adjacent segments' sums -- never exp(cum_i - cum_j) and never a ratio
// of exponentials: with the model's decay cum falls to about -280 over a
// 128-step chunk, where a difference of prefix sums keeps only ~1e-5 of
// its value and exp(cum) underflows to 0.  Entries above the diagonal are
// selected to 0, not multiplied (C.B^T above it is never loaded).  Rows
// at or past S (a ragged tail, or S < kQ) load as zeros with da = 0:
// identity decay and no contribution, so every length runs here.
// P <= kP and N <= kN in multiples of 4.
//
// What holds it back (chip_smoke.py's functions_ms at S = 2048; PERF.md):
// the output kernel takes about two thirds of the device time.  Its phases
// run in order inside a block -- load, C.h_in, load, L, G.xdt -- and two
// blocks on an SM overlap one's loads with the other's math.  Two
// pipelines measured slower on the card (PERF.md): the second phase's
// loads issued into a second buffer before C.h_in (212 KB a block, one
// block an SM), and kK-deep slices of both products in three cp.async
// stages (84 KB, two blocks an SM; a barrier a slice, and the decay's band
// leaves most warps idle in most slices).  The three launches move ~3x
// the function's bytes: each chunk state is written and read again, and
// every head reads the chunk's B, C and C.B^T.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "_attn_tile.cuh"

namespace {

using attn_tile::cp_async16;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;

constexpr int kQ = 128;         // steps per chunk
constexpr int kP = 64;          // largest head dim
constexpr int kN = 128;         // largest state size
constexpr int kRows = 64;       // rows of a C.B^T block's tile
constexpr int kRowTiles = kQ / kRows;
constexpr int kStateThreads = 256;
constexpr int kOutThreads = 256;
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 8;   // chunks a pass thread loads at once
// shared-memory row strides, in floats: 4 mod 32 where a fragment reads
// along a row, 8 mod 32 where it reads down a column
constexpr int kLdRow = kN + 4;  // also kQ + 4: C, C.B^T and B^T rows
constexpr int kLdColN = kN + 8; // B rows as the k-major A operand
constexpr int kLdColP = kP + 8; // xdt and h_in rows as the B operand
static_assert(kN == kQ, "kLdRow serves rows of N and of Q floats");
static_assert(2 * kQ == kOutThreads, "two threads per column of the scores");

constexpr size_t kStateSmem =
    sizeof(float) * (kQ * kLdColN + kQ * kLdColP + 3 * kQ);
constexpr size_t kCbSmem = sizeof(float) * (kRows * kLdRow + kQ * kLdRow);
constexpr size_t kSmem1 = kStateSmem > kCbSmem ? kStateSmem : kCbSmem;
constexpr size_t kSmem3 =
    sizeof(float) * (kQ * kLdRow + kQ * kLdColP + 3 * kQ);

__device__ __forceinline__ int round8(int k) { return (k + 7) & ~7; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

#ifndef SSD_F32_PRODUCTS

// x = hi + lo, each a TF32 value rounded to nearest (ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - __uint_as_float(h)));
  hi = h;
  lo = l & 0xffffe000u;
}

// c += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, a and b given as their hi and lo parts.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

#else

// A witness build (nvcc -DSSD_F32_PRODUCTS; scripts/ssd_f32_witness.py):
// the same fragments and the same order of sums, but every product an
// exact f32 FMA on the CUDA cores, so that its distance from the plain
// version is the rounding of 3xTF32's products and nothing else.  Not
// built by _build.py.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = 0u;
}

// c += a b with a's and b's fragments (the m16n8k8 layouts: a[q] at row g
// + 8 (q & 1), column t + 4 (q >> 1); b[q] at row t + 4 q, column g; c[e]
// at row g + 8 (e >> 1), column 2t + (e & 1)) gathered by shuffles.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&)[4],
                                     const uint32_t (&b)[2],
                                     const uint32_t (&)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = k >> 2;
    const int src_a = 4 * g + (k & 3);
    const float a0 = __uint_as_float(__shfl_sync(0xffffffffu, a[2 * q], src_a));
    const float a1 =
        __uint_as_float(__shfl_sync(0xffffffffu, a[2 * q + 1], src_a));
    const float b0 =
        __uint_as_float(__shfl_sync(0xffffffffu, b[q], 8 * t + (k & 3)));
    const float b1 =
        __uint_as_float(__shfl_sync(0xffffffffu, b[q], 8 * t + 4 + (k & 3)));
    c[0] = fmaf(a0, b0, c[0]);
    c[1] = fmaf(a0, b1, c[1]);
    c[2] = fmaf(a1, b0, c[2]);
    c[3] = fmaf(a1, b1, c[3]);
  }
}

#endif

// acc += A[m0:m0+32, k0:K] . B[k0:K, n0:n0+32] in 3xTF32, k0 and K
// multiples of 8.
// Each 8-deep step's three products start from zero and are added to acc
// in f32 by the CUDA cores: chained into acc itself, the tensor cores'
// rounding of the running sum read 1.6e-4 against the plain version on
// chip_smoke.py's S = 2 row (at |y| ~ 40), and 1.5e-5 flushed per step.
// A is read as A[m][k] = As[m * lda + k], or As[k * lda + m] (kAKMajor);
// B as B[k][n] = Bs[k * ldb + n], or Bs[n * ldb + k] (kBNMajor).  With
// g = lane / 4 and t = lane % 4, acc[mt][nt] holds rows m0 + 16 mt + g
// (+ 8 in [2], [3]) and columns n0 + 8 nt + 2t, + 1.
template <bool kAKMajor, bool kBNMajor>
__device__ __forceinline__ void warp_mma(float (&acc)[2][4][4],
                                         const float* As, int lda,
                                         const float* Bs, int ldb, int m0,
                                         int n0, int k0, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k = k0; k < K; k += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + 16 * mt + g + 8 * (q & 1);
        const int kk = k + t + 4 * (q >> 1);
        split_tf32(kAKMajor ? As[kk * lda + m] : As[m * lda + kk], ah[mt][q],
                   al[mt][q]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * nt + g;
        const int kk = k + t + 4 * q;
        split_tf32(kBNMajor ? Bs[n * ldb + kk] : Bs[kk * ldb + n], bh[nt][q],
                   bl[nt][q]);
      }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(part, ah[mt], al[mt], bh[nt], bl[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
      }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Copy `nrows` rows of `width` floats (a multiple of 4) into shared memory
// at stride `ld`, row r from src + r * src_ld, zeros where r >= valid_rows
// or past valid_cols.
template <int NTHREADS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          size_t src_ld, int nrows, int width,
                                          int valid_rows, int valid_cols) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < nrows * per_row; idx += NTHREADS) {
    const int r = idx / per_row;
    const int col = (idx - r * per_row) * 4;
    const bool ok = r < valid_rows && col < valid_cols;
    cp_async16(dst + r * ld + col, ok ? src + r * src_ld + col : src,
               ok ? 16 : 0);
  }
}

// C.B^T for rows r0 .. r0 + kRows of chunk c, all kQ columns; the 32x32
// tiles wholly above the diagonal are not formed (the output kernel never
// loads them).
__device__ __forceinline__ void cb_tile(float* sm, const float* Bm,
                                        const float* Cm, float* cb,
                                        size_t row0, int rows, int N, int r0,
                                        size_t cb_off) {
  float* Cs = sm;                    // [kRows][kLdRow]
  float* Bt = sm + kRows * kLdRow;   // [kQ][kLdRow], B as the n-major B
  load_rows<kStateThreads>(Cs, kLdRow, Cm + (row0 + r0) * N, N, kRows, kN,
                           rows - r0, N);
  load_rows<kStateThreads>(Bt, kLdRow, Bm + row0 * N, N, kQ, kN, rows, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = 32 * (warp >> 2);
  const int n0 = 32 * (warp & 3);
  if (n0 > r0 + m0 + 31) return;
  float acc[2][4][4];
  zero(acc);
  warp_mma<false, true>(acc, Cs, kLdRow, Bt, kLdRow, m0, n0, 0, round8(N));
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + m0 + 16 * mt + g + 8 * hf;
        const int j = n0 + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(cb + cb_off + (size_t)i * kQ + j) =
            make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
}

// Blocks x < H: the chunk state of head x.  Blocks x >= H: row tile
// x - H of the chunk's C.B^T.  y = chunk, z = batch.
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_state_mma_kernel(const float* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ a_log,
                     const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     float* __restrict__ states, float* __restrict__ tot,
                     float* __restrict__ cb, int S, int H, int P, int N) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * kQ;
  const int rows = min(kQ, S - t0);
  const size_t row0 = (size_t)bi * S + t0;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= H) {
    cb_tile(sm, Bm, Cm, cb, row0, rows, N, ((int)blockIdx.x - H) * kRows,
            ((size_t)bi * nc + c) * kQ * kQ);
    return;
  }
  const int h = blockIdx.x;
  float* Bs = sm;                      // [kQ][kLdColN]: B[j][n]
  float* Xs = Bs + kQ * kLdColN;       // [kQ][kLdColP]: w_j xdt[j][p]
  float* das = Xs + kQ * kLdColP;      // [kQ]
  float* ws = das + kQ;                // [kQ]
  float* dts = ws + kQ;                // [kQ]
  __shared__ int k_first;              // the first step with w_j != 0
  if (tid < kQ) {
    const float dtv = tid < rows ? dt[(row0 + tid) * H + h] : 0.f;
    dts[tid] = dtv;
    das[tid] = tid < rows ? dtv * -expf(a_log[h]) : 0.f;
  }
  __syncthreads();
  // w_j = exp(sum_{k>j} da_k): lane l sums steps 4l .. 4l+3 on its own
  // and takes the lanes above it by a suffix scan of those sums
  if (tid < 32) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = das[4 * tid + q];
    const float after2 = v[3];
    const float after1 = after2 + v[2];
    const float after0 = after1 + v[1];
    float incl = after0 + v[0];        // sum of this lane's and those above
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, incl, o);
      if (tid + o < 32) incl += u;
    }
    float above = __shfl_down_sync(0xffffffffu, incl, 1);
    if (tid == 31) above = 0.f;
    ws[4 * tid] = expf(above + after0);
    ws[4 * tid + 1] = expf(above + after1);
    ws[4 * tid + 2] = expf(above + after2);
    ws[4 * tid + 3] = expf(above);
    if (tid == 0) tot[((size_t)bi * nc + c) * H + h] = incl;
    // steps whose weight underflowed to 0 add nothing: the product starts
    // at the 8-step group of the first nonzero weight
    int first = kQ;
#pragma unroll
    for (int q = 3; q >= 0; --q)
      if (ws[4 * tid + q] != 0.f) first = 4 * tid + q;
    first = __reduce_min_sync(0xffffffffu, first);
    if (tid == 0) k_first = first & ~7;
  }
  __syncthreads();
  // B and x rows from k_first on (the rows before it are never read)
  const int k0 = k_first;
  load_rows<kStateThreads>(Bs + k0 * kLdColN, kLdColN, Bm + (row0 + k0) * N,
                           N, kQ - k0, kN, rows - k0, N);
  load_rows<kStateThreads>(Xs + k0 * kLdColP, kLdColP,
                           x + ((row0 + k0) * H + h) * P, (size_t)H * P,
                           kQ - k0, kP, rows - k0, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // xdt_j = x_j dt_j, then w_j xdt_j
  for (int idx = k0 * (kP / 4) + tid; idx < kQ * (kP / 4);
       idx += kStateThreads) {
    const int j = idx / (kP / 4);
    float* xp = Xs + j * kLdColP + (idx - j * (kP / 4)) * 4;
    const float dj = dts[j];
    const float wj = ws[j];
    float4 v = ld4(xp);
    v.x = v.x * dj * wj;
    v.y = v.y * dj * wj;
    v.z = v.z * dj * wj;
    v.w = v.w * dj * wj;
    st4(xp, v);
  }
  __syncthreads();
  // state[n][p] = sum_j B[j][n] (w_j xdt[j][p]): M = n, N = p, K = j
  const int warp = tid >> 5;
  const int m0 = 32 * (warp >> 1);
  const int n0 = 32 * (warp & 1);
  if (m0 >= N || n0 >= P) return;
  float acc[2][4][4];
  zero(acc);
  warp_mma<true, false>(acc, Bs, kLdColN, Xs, kLdColP, m0, n0, k0,
                        round8(rows));
  float* out = states + (((size_t)bi * nc + c) * H + h) * N * P;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = m0 + 16 * mt + g + 8 * hf;
        const int p = n0 + 8 * nt + 2 * t;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(out + (size_t)n * P + p) =
              make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
}

// Over the chunks in order: slot c of the chunk states becomes the state
// leaving chunk c, h_in[c+1] = d_c h_in[c] + state[c] with d_c =
// exp(total[c]), from h_in[0] = h0 (or zeros); the state after the last
// is hout.  Where d_c underflows to 0 the slot already holds h_in[c+1]
// and is neither read nor written: with the model's decay (total ~ -280)
// only the final state is copied.  A thread per 4 entries of [H, N, P];
// y = batch.
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ h0, float* __restrict__ states,
                const float* __restrict__ tot, float* __restrict__ hout,
                int H, int NP, int nc) {
  const size_t per = (size_t)H * NP;
  const size_t e = ((size_t)blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= per) return;
  const int bi = blockIdx.y;
  const int h = (int)(e / NP);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 hv = h0 != nullptr ? ld4(h0 + bi * per + e) : zero4;  // h_in[c]
  float* sp = states + (size_t)bi * nc * per + e;
  const float* tp = tot + (size_t)bi * nc * H + h;
  // kPassBatch chunks at a time: their loads are issued before their
  // stores, so that they are in flight together.  A slot is loaded where
  // its chunk's decay is not 0, where the next chunk's is not (it is the
  // state entering it) and for the last chunk (it is hout).
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float d[kPassBatch + 1];
#pragma unroll
    for (int u = 0; u <= kPassBatch; ++u)
      d[u] = c0 + u < nc ? expf(tp[(size_t)(c0 + u) * H]) : 0.f;
    float4 s[kPassBatch];
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const int c = c0 + u;
      s[u] = zero4;
      if (c < nc && (d[u] != 0.f || d[u + 1] != 0.f || c == nc - 1))
        s[u] = ld4(sp + (size_t)c * per);
    }
#pragma unroll
    for (int u = 0; u < kPassBatch; ++u) {
      const int c = c0 + u;
      if (c >= nc) continue;
      if (d[u] != 0.f) {
        hv = make_float4(fmaf(d[u], hv.x, s[u].x), fmaf(d[u], hv.y, s[u].y),
                         fmaf(d[u], hv.z, s[u].z), fmaf(d[u], hv.w, s[u].w));
        st4(sp + (size_t)c * per, hv);
      } else {
        hv = s[u];
      }
    }
  }
  st4(hout + bi * per + e, hv);
}

// y for chunk y of head x; z = batch.  8 warps, each a 32x32 tile of the
// chunk's [kQ, kP] output.
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_out_mma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log,
                   const float* __restrict__ Cm,
                   const float* __restrict__ h0,
                   const float* __restrict__ hin, const float* __restrict__ cb,
                   float* __restrict__ y, int S, int H, int P, int N) {
  extern __shared__ float4 smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);   // [kQ][kLdRow]
  float* Bs = As + kQ * kLdRow;                      // [kQ][kLdColP]
  float* das = Bs + kQ * kLdColP;                    // [kQ]
  float* es = das + kQ;                              // [kQ]: exp(cum_i)
  float* dts = es + kQ;                              // [kQ]
  // tpre[i] = sum of da over the steps of i's 8-step block up to i
  __shared__ float tpre[kQ];
  // nonzero[g][j]: G has a nonzero in column j among rows 32 g .. 32 g + 31
  __shared__ int nonzero[kQ / 32][kQ];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int bi = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * kQ;
  const int rows = min(kQ, S - t0);
  const size_t row0 = (size_t)bi * S + t0;
  const size_t chunk = ((size_t)bi * nc + c);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool has_state = c > 0 || h0 != nullptr;

  // the state entering the chunk: h0, or the slot of the chunk before
  if (has_state)
    load_rows<kOutThreads>(
        Bs, kLdColP,
        c == 0 ? h0 + ((size_t)bi * H + h) * N * P
               : hin + ((chunk - 1) * H + h) * N * P,
        P, kN, kP, N, P);
  cp_async_commit();
  if (tid < kQ) {
    const float dtv = tid < rows ? dt[(row0 + tid) * H + h] : 0.f;
    dts[tid] = dtv;
    das[tid] = tid < rows ? dtv * -expf(a_log[h]) : 0.f;
  }
  __syncthreads();
  // exp(cum_i): lane l sums steps 4l .. 4l+3 and takes the lanes below it
  // by a prefix scan of those sums
  if (tid < 32) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = das[4 * tid + q];
    const float upto0 = v[0];
    const float upto1 = upto0 + v[1];
    const float upto2 = upto1 + v[2];
    float incl = upto2 + v[3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += u;
    }
    float below = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) below = 0.f;
    es[4 * tid] = expf(below + upto0);
    es[4 * tid + 1] = expf(below + upto1);
    es[4 * tid + 2] = expf(below + upto2);
    es[4 * tid + 3] = expf(incl);
  } else if (tid >= kQ) {
    const int i = tid - kQ;
    float v = 0.f;
    for (int k = i & ~7; k <= i; ++k) v += das[k];
    tpre[i] = v;
  }
  __syncthreads();
  // C rows of the chunk where exp(cum_i) != 0 (zeros elsewhere: a row
  // whose decay underflowed takes nothing from h_in)
  if (has_state)
    for (int idx = tid; idx < kQ * (kN / 4); idx += kOutThreads) {
      const int i = idx / (kN / 4);
      const int n = (idx - i * (kN / 4)) * 4;
      const bool ok = i < rows && n < N && es[i] != 0.f;
      cp_async16(As + i * kLdRow + n, ok ? Cm + (row0 + i) * N + n : Cm,
                 ok ? 16 : 0);
    }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int m0 = 32 * (warp >> 1);
  const int n0 = 32 * (warp & 1);
  const bool warp_on = n0 < P && m0 < rows;
  float acc[2][4][4];
  zero(acc);
  // rows whose exp(cum_i) underflowed to 0 take nothing from h_in
  if (has_state && warp_on && __any_sync(0xffffffffu, es[m0 + lane] != 0.f)) {
    warp_mma<false, false>(acc, As, kLdRow, Bs, kLdColP, m0, n0, 0,
                           round8(N));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float e_lo = es[m0 + 16 * mt + g];
      const float e_hi = es[m0 + 16 * mt + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] *= e_lo;
        acc[mt][nt][1] *= e_lo;
        acc[mt][nt][2] *= e_hi;
        acc[mt][nt][3] *= e_hi;
      }
    }
  }
  __syncthreads();   // As and Bs are free

  // C.B^T on and below the diagonal (row i, the 4-column groups that
  // start at or before i) and the chunk's x rows
  const float* cbc = cb + chunk * kQ * kQ;
  for (int idx = tid; idx < kQ * (kQ / 4); idx += kOutThreads) {
    const int i = idx / (kQ / 4);
    const int j = (idx - i * (kQ / 4)) * 4;
    const bool ok = i < rows && j <= i;
    cp_async16(As + i * kLdRow + j, ok ? cbc + i * kQ + j : cbc, ok ? 16 : 0);
  }
  load_rows<kOutThreads>(Bs, kLdColP, x + (row0 * H + h) * P,
                         (size_t)H * P, kQ, kP, rows, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // G[i][j] = exp(sum_{j<k<=i} da_k) C_i.B_j for j <= i, else 0.  Thread
  // (j, half) takes column j over rows 64 half .. 64 half + 63, in blocks
  // of 8 rows.  In j's own block the sum runs from j + 1 one step at a
  // time; in a block b below it, it is R + tpre[i] with R = sum_{j<k<8b},
  // the suffix of j's block plus the totals of the blocks between: a sum
  // of adjacent segments' sums, never a difference, so the 8 rows of a
  // block are independent and the only chain is one add a block.  In the
  // same pass, x's rows become xdt_j = x_j dt_j.
  for (int idx = tid; idx < kQ * (kP / 4); idx += kOutThreads) {
    const int j = idx / (kP / 4);
    float* xp = Bs + j * kLdColP + (idx - j * (kP / 4)) * 4;
    const float dj = dts[j];
    float4 v = ld4(xp);
    v.x *= dj;
    v.y *= dj;
    v.z *= dj;
    v.w *= dj;
    st4(xp, v);
  }
  {
    const int j = tid % kQ;
    const int b0 = (tid / kQ) * (kQ / 16);   // first of the half's 8 blocks
    const int bj = j / 8;
    float R = 0.f;                           // sum_{j<k<8(bj+1)} da_k
    for (int k = j + 1; k < 8 * bj + 8; ++k) R += das[k];
    for (int b = bj + 1; b < b0; ++b) R += tpre[8 * b + 7];
    int nz = 0;   // bit g: a nonzero in rows 8 b0 + 32 g .. + 31
#pragma unroll 2
    for (int b = b0; b < b0 + kQ / 16; ++b) {
      float* gp = As + 8 * b * kLdRow + j;
      float gv[8];
      if (b < bj) {
#pragma unroll
        for (int r = 0; r < 8; ++r) gv[r] = 0.f;
      } else if (b == bj) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = 8 * b + r;
          s += i > j ? das[i] : 0.f;
          const float cbv = gp[r * kLdRow];
          gv[r] = i > j ? expf(s) * cbv : (i == j ? cbv : 0.f);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          gv[r] = expf(R + tpre[8 * b + r]) * gp[r * kLdRow];
        R += tpre[8 * b + 7];
      }
      bool any = false;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        gp[r * kLdRow] = gv[r];
        any |= gv[r] != 0.f;
      }
      nz |= (int)any << ((b - b0) / 4);
    }
    nonzero[b0 / 4][j] = nz & 1;
    nonzero[b0 / 4 + 1][j] = nz >> 1;
  }
  __syncthreads();
  if (!warp_on) return;
  // rows m0 .. m0 + 31 take columns j < m0 + 32, from the 8-column group
  // of their first nonzero G (a decay that underflowed to 0 gives 0)
  int first = kQ;
#pragma unroll
  for (int q = 3; q >= 0; --q)
    if (nonzero[m0 / 32][32 * q + lane]) first = 32 * q + lane;
  first = __reduce_min_sync(0xffffffffu, first);
  warp_mma<false, false>(acc, As, kLdRow, Bs, kLdColP, m0, n0,
                         min(first & ~7, m0 + 32), min(round8(rows), m0 + 32));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = m0 + 16 * mt + g + 8 * hf;
        const int p = n0 + 8 * nt + 2 * t;
        if (i < rows && p < P)
          *reinterpret_cast<float2*>(y + ((row0 + i) * H + h) * P + p) =
              make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
}

}  // namespace

extern "C" int ssd_chunk_scan_fwd(const void* x, const void* dt,
                                  const void* a_log,
                                  const void* B, const void* C,
                                  const void* h0, void* y, void* hout,
                                  void* states, void* tot, void* cb, int b,
                                  int S, int H, int P, int N, void* stream) {
  if (b == 0 || H == 0) return 0;
  if (P > kP || N > kN || P % 4 != 0 || N % 4 != 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kQ - 1) / kQ;
  const float* fx = static_cast<const float*>(x);
  const float* fdt = static_cast<const float*>(dt);
  const float* fa = static_cast<const float*>(a_log);
  const float* fB = static_cast<const float*>(B);
  const float* fC = static_cast<const float*>(C);
  float* fstates = static_cast<float*>(states);
  float* ftot = static_cast<float*>(tot);
  float* fcb = static_cast<float*>(cb);
  cudaError_t err;
  if (nc > 0) {
    err = attn_tile::allow_smem(ssd_state_mma_kernel, kSmem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_state_mma_kernel<<<dim3(H + kRowTiles, nc, b), kStateThreads, kSmem1,
                           st>>>(fx, fdt, fa, fB, fC, fstates, ftot, fcb, S,
                                 H, P, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t quads = (size_t)H * N * P / 4;
  ssd_pass_kernel<<<dim3((unsigned)((quads + kPassThreads - 1) / kPassThreads),
                         b),
                    kPassThreads, 0, st>>>(static_cast<const float*>(h0),
                                           fstates, ftot,
                                           static_cast<float*>(hout), H,
                                           N * P, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return static_cast<int>(err);
  err = attn_tile::allow_smem(ssd_out_mma_kernel, kSmem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_out_mma_kernel<<<dim3(H, nc, b), kOutThreads, kSmem3, st>>>(
      fx, fdt, fa, fC, static_cast<const float*>(h0), fstates, fcb,
      static_cast<float*>(y), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
