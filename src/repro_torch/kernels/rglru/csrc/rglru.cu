// RG-LRU diagonal linear recurrence for Hopper (sm_90a), f32.
//
// Replaces repro/kernels/rglru/kernel.py:rglru_scan_fwd (Pallas
// _rglru_kernel): h_t = a_t * h_{t-1} + b_t over the sequence axis of
// [B, S, W] f32 tensors, with h_{-1} = h0 [B, W] (zeros when null).
//
// What bounds it: bytes.  Each element of a and b is read once and h is
// written once (12 bytes per element) for 2 flops, so at the card's
// ~3.35 TB/s the bound is 3 * B*S*W*4 bytes over that rate (31 us at
// B = 1, S = 2100, W = 4096).
//
// Design.  Every (b, w) channel is independent and only the sequence axis
// carries a dependence, so a block owns kChannels = 32 channels of one
// batch row (a 128-byte row segment per step; 128 blocks at B = 1,
// W = 4096, about one per SM) and walks S in tiles of kTile steps.  The
// tiles of a and b arrive in shared memory by cp.async, kStages deep: two
// tiles (64 KB) are in flight while the block works on a third, which is
// what keeps an SM's share of the memory rate streaming (the TPU kernel's
// grid steps carried h in VMEM scratch; here one block walks its channels'
// whole sequence and needs no traffic between blocks).  Inside a tile,
// warp s owns segment s (kSeg = kTile / kWarps steps) and lane c its
// channel:
//   1. each thread folds its segment from zero into (prod a, b aggregate),
//      the combine (a_l, b_l) o (a_r, b_r) = (a_l * a_r, b_l * a_r + b_r),
//      and leaves the aggregate in shared memory;
//   2. each thread applies the aggregates of the segments before its own,
//      in order, to the carry entering the tile, and of all kWarps
//      segments for the carry leaving it (every thread keeps that in a
//      register, so no thread waits for another to pass it on);
//   3. each thread runs its segment again from its carry-in and writes h:
//      lanes hold neighbouring channels, so every store is one 128-byte
//      row segment.
// The copies go 4 bytes a lane (cp.async.ca), which takes any W and any
// alignment; a warp's copy of one row is still one 128-byte request.
// Rows past S and channels past W are copied as zeros and never written,
// so every length down to S = 1 runs here.
//
// Rounding: within a segment h is the sequential recurrence; across
// segments it goes through the aggregates, another order than the
// reference's doubling scan.  With |a| < 1 the recurrence is contractive
// and the two agree to ~1e-6.
//
// In flight: one thread per channel walking all of S would keep 16 loads
// in flight (64 blocks of two warps at B = 1, W = 4096, ~4 KB per SM);
// here 128 blocks of eight warps keep 64 KB in flight each.

#include <cuda_runtime.h>

#include <cstddef>

#include "_attn_tile.cuh"

namespace {

using attn_tile::cp_async4;
using attn_tile::cp_async_commit;
using attn_tile::cp_async_wait;

constexpr int kChannels = 32;              // a block's channels, one a lane
constexpr int kWarps = 8;                  // segments of a tile
constexpr int kTile = 128;                 // steps of a tile
constexpr int kSeg = kTile / kWarps;       // steps of a segment
constexpr int kStages = 3;                 // tiles in shared memory
constexpr int kThreads = kChannels * kWarps;

struct Smem {
  float a[kStages][kTile][kChannels];
  float b[kStages][kTile][kChannels];
  float agg_a[kWarps][kChannels];          // a segment's prod a
  float agg_b[kWarps][kChannels];          // and its b aggregate
};

// Tile `tile` of the block's channels into stage `st`: warp s copies rows
// s, s + kWarps, ...; zeros past S and past W.
__device__ __forceinline__ void load_tile(Smem& sm, int st, int tile,
                                          const float* a, const float* b,
                                          size_t base, int S, int W,
                                          bool lane_ok) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int r = warp; r < kTile; r += kWarps) {
    const int t = tile * kTile + r;
    const bool ok = lane_ok && t < S;
    const size_t off = ok ? base + (size_t)t * W : 0;
    cp_async4(&sm.a[st][r][lane], a + off, ok ? 4 : 0);
    cp_async4(&sm.b[st][r][lane], b + off, ok ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_tile_scan_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       int S, int W) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int bi = blockIdx.y;
  const int w = blockIdx.x * kChannels + lane;
  const bool lane_ok = w < W;
  const size_t base = (size_t)bi * S * W + w;   // (bi, t = 0, w)
  const int tiles = (S + kTile - 1) / kTile;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < tiles) load_tile(sm, st, st, a, b, base, S, W, lane_ok);
    cp_async_commit();
  }
  // the carry entering the current tile, in every thread of the channel
  float carry = (h0 != nullptr && lane_ok) ? h0[(size_t)bi * W + w] : 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // the tile landed; stage tile-1 and agg are free
    {
      const int next = tile + kStages - 1;
      if (next < tiles)
        load_tile(sm, next % kStages, next, a, b, base, S, W, lane_ok);
      cp_async_commit();
    }
    const int st = tile % kStages;
    const float* ta = &sm.a[st][seg * kSeg][lane];
    const float* tb = &sm.b[st][seg * kSeg][lane];

    // 1. the segment's aggregate, folded from zero
    float pa = 1.f, pb = 0.f;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const float ai = ta[i * kChannels];
      pb = fmaf(pb, ai, tb[i * kChannels]);
      pa *= ai;
    }
    sm.agg_a[seg][lane] = pa;
    sm.agg_b[seg][lane] = pb;
    __syncthreads();

    // 2. carry into this segment, and out of the tile
    float hin = carry;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) {
      if (s == seg) hin = carry;
      carry = fmaf(sm.agg_a[s][lane], carry, sm.agg_b[s][lane]);
    }

    // 3. the segment again from its carry-in, writing h
    const int t0 = tile * kTile + seg * kSeg;
    float* out = h + base + (size_t)t0 * W;
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      hin = fmaf(ta[i * kChannels], hin, tb[i * kChannels]);
      if (lane_ok && t0 + i < S) out[(size_t)i * W] = hin;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" int rglru_scan_fwd(const void* a, const void* b, const void* h0,
                              void* h, int B, int S, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const size_t smem = sizeof(Smem);
  cudaError_t err = attn_tile::allow_smem(rglru_tile_scan_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kChannels - 1) / kChannels, B);
  rglru_tile_scan_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}
