// Mamba-2 SSD chunk scan for Hopper (sm_90a), f32.
//
// Replaces repro/kernels/ssd/kernel.py:ssd_chunk_scan_fwd (Pallas
// _ssd_kernel).  For each (batch, head), over the sequence in chunks of kQ
// steps, with cum the in-chunk cumulative sum of the log decay da:
//
//   y     = (L o C.B^T) . xdt + exp(cum) * (C . h_in)
//   h_out = exp(total) * h_in + (B o exp(total - cum))^T . xdt
//   L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//
// Inputs: xdt [b,S,H,P] and da [b,S,H] f32, pre-scaled by the wrapper;
// B, C [b,S,N] f32, shared by all heads; h0 [b,H,N,P] f32 or null (zeros).
// Outputs: y [b,S,H,P] f32 and the final state hout [b,H,N,P] f32.
//
// What bounds it: operations.  At the serving shape (S = 2048, H = 80,
// P = 64, N = 128) it reads and writes ~90 MB (27 us at 3.35 TB/s) but does
// ~6.7 GFLOP of f32 math (0.10 ms at the 67 TFLOP/s f32 peak).
//
// Design.  The TPU grid (b, H, n_chunks) carries the [N,P] state in VMEM
// scratch across its sequential chunk axis; Hopper runs blocks in no
// order, so here one block per (b, h) loops over the chunks itself and
// keeps the 128x64 f32 state (32 KB) in shared memory.  A chunk of kQ = 64
// steps (not the model's 256: a 256x256 f32 score tile alone is 256 KB)
// is staged whole in shared memory: B and C [kQ,N], xdt [kQ,P], the
// masked decay-weighted scores G = L o C.B^T [kQ,kQ], ~135 KB in all.
// 256 threads run four phases per chunk, each a register-tiled f32 product
// over shared memory (float4 reads, rows padded by 4 floats so that the
// reads of a quarter-warp hit distinct banks):
//   1. warp 0 scans da (shuffles) into cum and exp(cum); meanwhile 64
//      other threads each run down one column j of the chunk, writing the
//      segment sums sum_{j<k<=i} da_k into G and ending at the suffix sum
//      of exp(total - cum_j);
//   2. G = L o C.B^T, a 4x4 tile of (i, j) per thread;
//   3. y = exp(cum) * C.h_in + G.xdt, a 4x4 tile of (i, p) per thread;
//   4. h = exp(total) * h + B^T.(w o xdt), an 8x4 tile of (n, p) each.
// L and exp(total - cum_j) are exponentials of segment sums, never ratios
// of exponentials: with a strong decay cum falls far below -100 within a
// chunk and exp(cum) underflows to 0, so a ratio would be 0/0.  Each
// segment is summed on its own rather than as cum_i - cum_j: with the
// model's decay cum reaches about -140 in 64 steps, where that difference
// keeps only ~1e-5 of its value, enough to miss the plain version at
// 2e-4 where y's terms cancel.  Entries above the diagonal are selected
// to 0, not multiplied.
// Rows at or past S (a ragged tail, or S < kQ) are loaded as zeros with
// da = 0: identity decay and no contribution, so every length runs here.
// P <= kP and N <= kN in multiples of 4 (zero-padded to the maximum).
//
// Known costs of this first version: at b = 1 it fills 80 of the 132 SMs
// (one block per head); C.B^T is the same for every head of a chunk and is
// recomputed per head (the reference computed it once); the loads of a
// chunk are not overlapped with the math; no tensor cores.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kQ = 64;          // steps per chunk
constexpr int kP = 64;          // largest head dim
constexpr int kN = 128;         // largest state size
constexpr int kThreads = 256;
constexpr int kPadN = kN + 4;   // shared-memory row strides, in floats
constexpr int kPadP = kP + 4;
constexpr int kPadQ = kQ + 4;

struct Smem {
  float B[kQ * kPadN];
  float C[kQ * kPadN];
  float X[kQ * kPadP];
  float H[kN * kPadP];          // the carried state, [n][p]
  float G[kQ * kPadQ];          // L o C.B^T, [i][j]
  float da[kQ];
  float cum[kQ];                // in-chunk cumulative log decay
  float ec[kQ];                 // exp(cum_i)
  float w[kQ];                  // exp(sum_{k>j} da_k) = exp(total - cum_j)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return reinterpret_cast<const float*>(&v)[k];
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const float* __restrict__ xdt,
                      const float* __restrict__ da,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hout, int S, int H, int P, int N) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int bi = bh / H;
  const int h = bh - bi * H;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < kN * (kP / 4); idx += kThreads) {
    const int n = idx / (kP / 4);
    const int p = (idx % (kP / 4)) * 4;
    float4 v = zero;
    if (h0 != nullptr && n < N && p < P)
      v = ld4(h0 + ((size_t)bh * N + n) * P + p);
    st4(&sm.H[n * kPadP + p], v);
  }

  const int nchunks = (S + kQ - 1) / kQ;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ;
    const int rows = min(kQ, S - t0);
    const size_t row0 = (size_t)bi * S + t0;

    // -- load the chunk; rows past S and columns past N, P are zeros
    for (int idx = tid; idx < kQ * (kN / 4); idx += kThreads) {
      const int r = idx / (kN / 4);
      const int n = (idx % (kN / 4)) * 4;
      float4 vb = zero, vc = zero;
      if (r < rows && n < N) {
        vb = ld4(Bm + (row0 + r) * N + n);
        vc = ld4(Cm + (row0 + r) * N + n);
      }
      st4(&sm.B[r * kPadN + n], vb);
      st4(&sm.C[r * kPadN + n], vc);
    }
    for (int idx = tid; idx < kQ * (kP / 4); idx += kThreads) {
      const int r = idx / (kP / 4);
      const int p = (idx % (kP / 4)) * 4;
      float4 v = zero;
      if (r < rows && p < P) v = ld4(xdt + ((row0 + r) * H + h) * P + p);
      st4(&sm.X[r * kPadP + p], v);
    }
    if (tid < kQ) sm.da[tid] = tid < rows ? da[(row0 + tid) * H + h] : 0.f;
    __syncthreads();

    // -- 1. log decays: the in-chunk prefix (warp 0, two steps a lane),
    //       and the segment sums of each column j (threads 64 .. 127)
    if (tid < 32) {
      const float a0 = sm.da[2 * tid];
      const float a1 = sm.da[2 * tid + 1];
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += u;
      }
      sm.cum[2 * tid] = s - a1;
      sm.cum[2 * tid + 1] = s;
      sm.ec[2 * tid] = expf(s - a1);
      sm.ec[2 * tid + 1] = expf(s);
    } else if (tid >= 64 && tid < 64 + kQ) {
      const int j = tid - 64;
      float s = 0.f;
      sm.G[j * kPadQ + j] = 0.f;
      for (int i = j + 1; i < kQ; ++i) {
        s += sm.da[i];
        sm.G[i * kPadQ + j] = s;
      }
      sm.w[j] = expf(s);
    }
    __syncthreads();
    const float total = sm.cum[kQ - 1];

    // -- 2. G[i][j] = exp(sum_{j<k<=i} da_k) * C_i.B_j for j <= i, else
    //       0, over the segment sums in place; rows i = ty + 16a, columns
    //       j = tx + 16b
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = ld4(&sm.C[(ty + 16 * a) * kPadN + n]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          bv[b] = ld4(&sm.B[(tx + 16 * b) * kPadN + n]);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = fmaf(cv[a].x, bv[b].x, acc[a][b]);
            acc[a][b] = fmaf(cv[a].y, bv[b].y, acc[a][b]);
            acc[a][b] = fmaf(cv[a].z, bv[b].z, acc[a][b]);
            acc[a][b] = fmaf(cv[a].w, bv[b].w, acc[a][b]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = ty + 16 * a;
          const int j = tx + 16 * b;
          float* g = &sm.G[i * kPadQ + j];
          *g = j <= i ? expf(*g) * acc[a][b] : 0.f;
        }
    }

    // -- 3. y rows i = ty + 16a, columns p = 4tx .. 4tx+3
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;
      // inter-chunk: exp(cum_i) * C_i . h_in (h_in is read here only,
      // before the barrier below, so phase 4 may overwrite it after it)
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          cv[a] = ld4(&sm.C[(ty + 16 * a) * kPadN + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float4 hv = ld4(&sm.H[(n + nn) * kPadP + 4 * tx]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float cf = at(cv[a], nn);
            acc[a][0] = fmaf(cf, hv.x, acc[a][0]);
            acc[a][1] = fmaf(cf, hv.y, acc[a][1]);
            acc[a][2] = fmaf(cf, hv.z, acc[a][2]);
            acc[a][3] = fmaf(cf, hv.w, acc[a][3]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = sm.ec[ty + 16 * a];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[a][k] *= e;
      }
      __syncthreads();   // G complete
      // intra-chunk: G_i . xdt (rows of xdt past the tail are zeros)
      for (int j = 0; j < rows; j += 4) {
        float4 gv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          gv[a] = ld4(&sm.G[(ty + 16 * a) * kPadQ + j]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 xv = ld4(&sm.X[(j + jj) * kPadP + 4 * tx]);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float g = at(gv[a], jj);
            acc[a][0] = fmaf(g, xv.x, acc[a][0]);
            acc[a][1] = fmaf(g, xv.y, acc[a][1]);
            acc[a][2] = fmaf(g, xv.z, acc[a][2]);
            acc[a][3] = fmaf(g, xv.w, acc[a][3]);
          }
        }
      }
      if (4 * tx < P) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ty + 16 * a;
          if (i < rows)
            st4(y + ((row0 + i) * H + h) * P + 4 * tx,
                make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
        }
      }
    }

    // -- 4. state: h[n][p] = exp(total) * h + sum_j B[j][n] w_j xdt[j][p];
    //       rows n = 8ty .. 8ty+7, columns p = 4tx .. 4tx+3
    {
      float acc[8][4];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[m][k] = 0.f;
      for (int j = 0; j < rows; ++j) {
        const float wj = sm.w[j];
        float4 xv = ld4(&sm.X[j * kPadP + 4 * tx]);
        xv.x *= wj;
        xv.y *= wj;
        xv.z *= wj;
        xv.w *= wj;
        const float4 b0 = ld4(&sm.B[j * kPadN + 8 * ty]);
        const float4 b1 = ld4(&sm.B[j * kPadN + 8 * ty + 4]);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float bv = m < 4 ? at(b0, m) : at(b1, m - 4);
          acc[m][0] = fmaf(bv, xv.x, acc[m][0]);
          acc[m][1] = fmaf(bv, xv.y, acc[m][1]);
          acc[m][2] = fmaf(bv, xv.z, acc[m][2]);
          acc[m][3] = fmaf(bv, xv.w, acc[m][3]);
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float* hp = &sm.H[(8 * ty + m) * kPadP + 4 * tx];
        float4 hv = ld4(hp);
        hv.x = fmaf(decay, hv.x, acc[m][0]);
        hv.y = fmaf(decay, hv.y, acc[m][1]);
        hv.z = fmaf(decay, hv.z, acc[m][2]);
        hv.w = fmaf(decay, hv.w, acc[m][3]);
        st4(hp, hv);
      }
    }
    __syncthreads();   // the next chunk's loads overwrite B, C, X
  }

  __syncthreads();
  if (4 * tx < P) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int n = 8 * ty + m;
      if (n < N)
        st4(hout + ((size_t)bh * N + n) * P + 4 * tx,
            ld4(&sm.H[n * kPadP + 4 * tx]));
    }
  }
}

}  // namespace

extern "C" int ssd_chunk_scan_fwd(const void* xdt, const void* da,
                                  const void* B, const void* C,
                                  const void* h0, void* y, void* hout, int b,
                                  int S, int H, int P, int N, void* stream) {
  if (b == 0 || H == 0) return 0;
  if (P > kP || N > kN || P % 4 != 0 || N % 4 != 0 || P <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<<<b * H, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(da),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hout), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
