// DWI per-image, per-channel z-score -> clip -> [0, 1], sm_90a.
//
// Replaces the TPU kernel `_dwi_norm_kernel`
// (dmf_tpu/ops/preprocess_pallas.py:28), reached through
// `dwi_normalize_pallas` (:49).  Built by ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes
// (ops/dwi_norm_cuda.py).
//
// Per image n and channel c of contiguous (N, H*W, C) images in fp32, bf16 or
// fp16 (T), with the numerics of the plain version (ops/dwi_norm.py):
//   mean, M2 = the fp32 mean and centred sum of squares of the upcast pixels
//   std      = max(sqrt(M2 / (HW - 1)), 1e-6)      unbiased
//   out      = round_T((clip((x - mean) / std, lo, hi) - lo) / (hi - lo))
// and the last channel kept (skip_last) or zeroed (skip_last and zero_last).
// The two divisions are products with the reciprocals 1/std and 1/(hi - lo),
// taken once per channel: within an ulp or two of the quotients in fp32,
// and they keep the bf16 pass from being bound by division.
//
// What bounds it on this card: memory traffic, one read and one write of the
// images (the served batch, 8 x 256^2 x 13 fp32: 54.5 MB, 16 us).  The TPU
// kernel holds a whole image in VMEM; an SM cannot (one image is 3.4 MB), and
// one block per image would keep only N of 132 SMs busy.  So the statistics
// are split over (image, P pixels), in three kernels that one C entry point
// enqueues:
//   1. dwi_partials, one block per (image, P pixels) on a 1-D grid with
//      64-bit offsets.  The block loads its tile into registers (kItems
//      16-byte vectors a thread, all in flight at once), then takes the
//      tile's per-channel mean and, on a second walk over the same
//      registers, its centred M2: the tile is read from HBM once.
//   2. dwi_merge, one block per image: Chan's parallel merge of the image's
//      nb partial rows in a fixed order,
//        mean = sum_b n_b mean_b / HW,  M2 = sum_b M2_b + n_b (mean_b - mean)^2,
//      into the image's mean and 1/std.  (Merging in every block of step 3
//      instead measured 1.6x slower at 256 images, 1.25x at 8: each of
//      thousands of blocks read its image's rows; PERF.md.)
//   3. dwi_apply, one block per (image, P pixels), walked in the reverse of
//      step 1's order (at the served batch the images, 27 MB, fit in the
//      50 MB L2, and the tiles step 1 read last are read first).
// Raw DWI intensities run into the thousands, where an fp32
// sum(x^2) - n mean^2 loses digits; centred sums do not.  That is two reads
// and one write of the images against the bound's one read and one write.
//
// The walk: C is 13 or 14, where a 16-byte vector (4 fp32, 8 bf16/fp16) does
// not line up with a pixel.  A block of T threads walks its tile (P pixels x
// C channels, contiguous) as a flat run of vectors, with T chosen so that
// VEC * T is a multiple of C (fp32 C = 13: T = 208): lane k of thread t then
// always holds channel (VEC * t + k) mod C, its sums stay in registers, and
// the channels' sums meet in shared memory once a walk (split_pool.cuh, as
// the standalone SE's).  VEC is 1 where the images are not 16-byte aligned
// or HW * C is not a multiple of the vector.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "split_pool.cuh"

namespace {

using namespace split_pool;

constexpr int kItems = 8;            // vectors a thread holds: P * C = kItems * VEC * T
constexpr int kThreads = 256;        // the most threads a block of steps 1 and 3 takes
constexpr int kMergeThreads = 1024;  // a block of step 2
constexpr int kMaxC = 128;
constexpr int kRedFloats = 2048;     // lane sums: VEC x T; step 2's slice sums

// element conversions; bf16 -> fp32 is a shift, and fp32 -> 16-bit types
// convert two at a time
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<unsigned>(__bfloat16_as_ushort(v)) << 16);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename S, int VEC>
__device__ __forceinline__ void from_f(const float (&y)[VEC], S (&o)[VEC]) {
  if constexpr (std::is_same_v<S, float>) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = y[k];
  } else if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      if constexpr (std::is_same_v<S, __nv_bfloat16>) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(y[k], y[k + 1]);
        o[k] = p.x;
        o[k + 1] = p.y;
      } else {
        const __half2 p = __floats2half2_rn(y[k], y[k + 1]);
        o[k] = p.x;
        o[k + 1] = p.y;
      }
    }
  } else if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    o[0] = __float2bfloat16_rn(y[0]);
  } else {
    o[0] = __float2half_rn(y[0]);
  }
}

// A thread's kItems vectors of its block's tile: vector i holds the elements
// VEC * (t + i * T) .. + VEC - 1 of the tile; vectors past the tile's end are
// not loaded.
template <typename S, int VEC>
struct TileRegs {
  using R = typename Raw<sizeof(S) * VEC>::type;
  alignas(sizeof(R)) S v[kItems][VEC];

  __device__ __forceinline__ void load(const S* base, int len) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int f = VEC * (threadIdx.x + i * blockDim.x);
      if (f < len) *reinterpret_cast<R*>(v[i]) = *reinterpret_cast<const R*>(base + f);
    }
  }
};

// Step 1: the tile's per-channel mean -> pmean[blk], centred M2 -> pm2[blk].
template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
dwi_partials(const S* __restrict__ x, float* __restrict__ pmean, float* __restrict__ pm2,
             long long hw, int c, int p_blk, int nb) {
  __shared__ float red[kRedFloats];
  __shared__ float chan[kMaxC];
  const long long blk = blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  const int len = static_cast<int>(t.p1 - t.p0) * c;
  TileRegs<S, VEC> tile;
  tile.load(x + (t.n * hw + t.p0) * c, len);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (VEC * (threadIdx.x + i * blockDim.x) < len)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f(tile.v[i][k]);
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[VEC * threadIdx.x + k] = acc[k];
  __syncthreads();
  const float cnt = static_cast<float>(t.p1 - t.p0);
  channel_sums(red, VEC * blockDim.x, c, chan);
  float mk[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    mk[k] = chan[(VEC * threadIdx.x + k) % c] / cnt;
    acc[k] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (VEC * (threadIdx.x + i * blockDim.x) < len)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = to_f(tile.v[i][k]) - mk[k];
        acc[k] += d * d;
      }
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) pmean[blk * c + ch] = chan[ch] / cnt;
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[VEC * threadIdx.x + k] = acc[k];
  __syncthreads();
  channel_sums(red, VEC * blockDim.x, c, pm2 + blk * c);
}

// Step 2: Chan's merge of image n's nb partial rows -> stats[n] = (mean,
// 1/std) per channel.  Slice q of m sums rows q, q + m, ... of its channel,
// then each channel adds its slices in order.
__global__ void __launch_bounds__(kMergeThreads)
dwi_merge(const float* __restrict__ pmean, const float* __restrict__ pm2,
          float* __restrict__ stats, long long hw, int c, int p_blk, int nb) {
  __shared__ float red[kRedFloats];
  __shared__ float mean_s[kMaxC];
  const long long n = blockIdx.x;
  const float* mrow = pmean + n * nb * c;
  const float* m2row = pm2 + n * nb * c;
  const int m = max(1, min(static_cast<int>(blockDim.x) / c, nb));
  const auto pixels = [&](int b) {  // of partial row b
    return static_cast<float>(min(static_cast<long long>(p_blk),
                                  hw - static_cast<long long>(b) * p_blk));
  };
  for (int i = threadIdx.x; i < m * c; i += blockDim.x) {
    const int q = i / c, ch = i % c;
    float s = 0.0f;
    for (int b = q; b < nb; b += m) s += pixels(b) * mrow[b * c + ch];
    red[i] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < m; ++q) s += red[q * c + ch];
    mean_s[ch] = s / static_cast<float>(hw);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * c; i += blockDim.x) {
    const int q = i / c, ch = i % c;
    const float mean = mean_s[ch];
    float s = 0.0f;
    for (int b = q; b < nb; b += m) {
      const float d = mrow[b * c + ch] - mean;
      s += m2row[b * c + ch] + pixels(b) * d * d;
    }
    red[i] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < m; ++q) s += red[q * c + ch];
    stats[2 * n * c + ch] = mean_s[ch];
    stats[(2 * n + 1) * c + ch] = 1.0f / fmaxf(sqrtf(s / static_cast<float>(hw - 1)), 1e-6f);
  }
}

// Step 3: the tile, normalised with its image's statistics.
template <typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
dwi_apply(const S* __restrict__ x, S* __restrict__ out, const float* __restrict__ stats,
          long long hw, int c, int p_blk, int nb, float z_lo, float z_hi, int skip_last,
          int zero_last) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  const long long blk = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  const long long e0 = (t.n * hw + t.p0) * c;
  const int len = static_cast<int>(t.p1 - t.p0) * c;
  TileRegs<S, VEC> tile;
  tile.load(x + e0, len);
  const float inv_range = 1.0f / (z_hi - z_lo);
  float mk[VEC], ik[VEC];
  bool last[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int ch = (VEC * threadIdx.x + k) % c;
    mk[k] = stats[2 * t.n * c + ch];
    ik[k] = stats[(2 * t.n + 1) * c + ch];
    last[k] = skip_last && ch == c - 1;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int f = VEC * (threadIdx.x + i * blockDim.x);
    if (f < len) {
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = to_f(tile.v[i][k]);
        const float z = fminf(fmaxf((v - mk[k]) * ik[k], z_lo), z_hi);
        y[k] = !last[k] ? (z - z_lo) * inv_range : zero_last ? 0.0f : v;
      }
      alignas(sizeof(R)) S o[VEC];
      from_f(y, o);
      *reinterpret_cast<R*>(out + e0 + f) = *reinterpret_cast<const R*>(o);
    }
  }
}

template <typename S, int VEC>
int launch(const void* x, void* out, void* part, long long n, long long hw, int c, int threads,
           int p_blk, float z_lo, float z_hi, int skip_last, int zero_last, cudaStream_t stream) {
  const int nb = static_cast<int>((hw + p_blk - 1) / p_blk);
  const long long blocks = n * nb;
  if (c < 1 || c > kMaxC || hw < 2 || threads < 1 || threads > kThreads ||
      (VEC * threads) % c || VEC * threads > kRedFloats ||
      static_cast<long long>(p_blk) * c != static_cast<long long>(kItems) * VEC * threads ||
      (hw * c) % VEC || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pmean = static_cast<float*>(part);
  float* pm2 = pmean + blocks * c;
  float* stats = pm2 + blocks * c;
  dwi_partials<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), pmean, pm2, hw, c, p_blk, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dwi_merge<<<static_cast<unsigned>(n), kMergeThreads, 0, stream>>>(pmean, pm2, stats, hw, c,
                                                                   p_blk, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dwi_apply<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out), stats, hw, c, p_blk, nb, z_lo, z_hi,
      skip_last, zero_last);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: contiguous (N, HW, C) images; dtype 0 fp32, 1 bf16, 2 fp16.  part:
// fp32 scratch of 2 x N x ceil(HW / p_blk) x C (the tiles' means, then their
// M2) + 2 x N x C (the images' means and 1/std).  vec: elements per vector
// load, the full 16 bytes (4 fp32, 8 bf16 or fp16) or 1; threads: a block of
// steps 1 and 3, with vec * threads a multiple of C and p_blk * C = kItems
// (8) * vec * threads.  Enqueues the three kernels on `stream`; returns the
// first CUDA error, or 0.
extern "C" int dwi_norm_launch(int dtype, int vec, const void* x, void* out, void* part,
                               long long n, long long hw, int c, int threads, int p_blk,
                               float z_lo, float z_hi, int skip_last, int zero_last,
                               void* stream) {
  if (n <= 0) return 0;
  if (p_blk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DWI_NORM_ARGS \
  x, out, part, n, hw, c, threads, p_blk, z_lo, z_hi, skip_last, zero_last, st
  if (dtype == 0) {
    if (vec == 4) return launch<float, 4>(DWI_NORM_ARGS);
    if (vec == 1) return launch<float, 1>(DWI_NORM_ARGS);
  } else if (dtype == 1) {
    if (vec == 8) return launch<__nv_bfloat16, 8>(DWI_NORM_ARGS);
    if (vec == 1) return launch<__nv_bfloat16, 1>(DWI_NORM_ARGS);
  } else if (dtype == 2) {
    if (vec == 8) return launch<__half, 8>(DWI_NORM_ARGS);
    if (vec == 1) return launch<__half, 1>(DWI_NORM_ARGS);
  }
#undef DWI_NORM_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
