// The pieces of a reduction split over (sample, pixel block) that the port's
// per-channel reduction kernels share: the SE kernels (se_epilogue.cu,
// se_scale.cu, through se_mlp.cuh) and the DWI z-score (dwi_norm.cu).
//
// A block takes P pixels of one sample of a channels-last batch (N, HW, C):
// the tile is P x C contiguous elements.  Its T threads walk the tile as a
// flat run of VEC-element vectors, thread t taking elements VEC * (t + i * T)
// onwards; where VEC * T is a multiple of C, lane k of thread t always holds
// channel (VEC * t + k) mod C, so its sums stay in registers and the
// channels' sums meet in shared memory once (channel_sums).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace split_pool {

// a VEC-element vector of S as one load or store
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

struct Tile {  // the (sample, pixel block) of a block of a pixel pass
  long long n, p0, p1;
};

__device__ __forceinline__ Tile tile_of(long long blk, long long hw, int p_blk, int nb) {
  Tile t;
  t.n = blk / nb;
  t.p0 = (blk % nb) * p_blk;
  t.p1 = min(t.p0 + p_blk, hw);
  return t;
}

// Per-channel sums of a block's lane sums.  red[i], i < len (a multiple of
// c), belongs to channel i mod c.  Slice q of m slices adds rows q, q + m, ...
// of its channel and leaves the sum in row q (no other slice reads that row);
// then each channel adds its m slice sums, in order, into out[ch]: a fixed
// order, so a result is the same run to run.  Every thread of the block
// calls it; red is ready (synchronised) on entry, and red may be written
// again and out read by every thread on return.
__device__ __forceinline__ void channel_sums(float* red, int len, int c, float* out) {
  const int rows = len / c;
  const int m = max(1, min(static_cast<int>(blockDim.x) / c, rows));
  for (int i = threadIdx.x; i < m * c; i += blockDim.x) {
    const int q = i / c, ch = i % c;
    float s = 0.0f;
    for (int r = q; r < rows; r += m) s += red[r * c + ch];
    red[q * c + ch] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < m; ++q) s += red[q * c + ch];
    out[ch] = s;
  }
  __syncthreads();
}

}  // namespace split_pool
