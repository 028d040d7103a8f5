// Standalone squeeze-excitation (x * s, s), sm_90a.
//
// Replaces the TPU kernel `_se_kernel` (dmf_tpu/ops/se_pallas.py:110), reached
// through `se_scale` (:202).  Built by ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes (ops/se_cuda.py).
//
// Per sample n of a channels-last batch (N, H*W, C) in fp32 or bf16 (T), with
// the rounding points of the plain version (ops/se.py):
//   pool = round_T(sum_pixels(x) / HW)    fp32 sum
//   h    = round_T(gelu(W1 pool + b1))    fp32 accumulation
//   s    = sigmoid(W2 h + b2)             fp32; returned rounded to T
//   out  = round_T(x * s)
//
// What bounds it on this card: memory traffic.  The MLP is C x C/2 on one
// vector per sample, so the least time is one read and one write of the map
// (a tta_mc request at B=8: 32 x 256^2 x 14 bf16, 58.7 MB, 17.5 us).  The
// pool needs all of a sample's pixels before any output can be scaled, and a
// 256^2 map does not fit in an SM, so the design is kernel 1's split
// reduction over (sample, pixel block), without its add, GELU and dropout:
// three kernels that one C entry point enqueues,
//   1. se_pool_partials, one block per (sample, P pixels) on a 1-D grid with
//      64-bit offsets: the block's per-channel fp32 sum as one row of
//      partials (N, nb, C).  No atomics, so a result is the same run to run.
//   2. epi_mlp (se_mlp.cuh), kernel 1's MLP kernel (instantiated under the
//      tag se_scale_mlp), which also writes s in the map dtype.
//   3. se_apply, one block per (sample, P pixels): out = round_T(x * s), out
//      of place, walking the blocks in the reverse of phase 1's order, so the
//      tiles phase 1 read last are read again while they are still in L2
//      (the modality-SE maps, 12.6-29 MB, fit in the 50 MB L2 whole).
// That is two reads and one write of the map against the bound's one read
// and one write; where the map fits in L2 the second read costs little HBM.
//
// The walk: C is 6 or 14 at the modality attention, where a 16-byte vector
// (8 bf16, 4 fp32) does not line up with a pixel.  A block of T threads walks
// its tile (P pixels x C channels, contiguous) as a flat run of vectors, with
// T chosen so that VEC * T is a multiple of C (bf16: T = 192 at C = 6, 224 at
// C = 14): lane k of thread t then always holds channel (VEC * t + k) mod C,
// its sums stay in registers, and the channels' sums meet in shared memory
// once, at the end of the tile (split_pool.cuh).  At C a multiple of VEC
// (fusion_se, C = 128) the same walk is kernel 1's per-pixel layout.  VEC is
// 1 where the map is not 16-byte aligned or HW * C is not a multiple of the
// vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "se_mlp.cuh"

struct se_scale_mlp;  // names this kernel's instance of se_mlp::epi_mlp

namespace {

using namespace se_mlp;

constexpr int kMaxThreads = 256;  // a block of phases 1 and 3 at VEC > 1
constexpr int kRedFloats = 2048;  // phase 1's lane sums: VEC x T

// Phase 1: the block's per-channel fp32 sum -> part[blk].
template <typename S, int VEC>
__global__ void __launch_bounds__(VEC == 1 ? 1024 : kMaxThreads)
se_pool_partials(const S* __restrict__ x, float* __restrict__ part, long long hw, int c,
                 int p_blk, int nb) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  __shared__ float red[kRedFloats];
  const long long blk = blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  const S* base = x + (t.n * hw + t.p0) * c;
  const int len = static_cast<int>(t.p1 - t.p0) * c;
  const int stride = VEC * blockDim.x;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
  for (int f = VEC * threadIdx.x; f < len; f += stride) {
    alignas(sizeof(R)) S v[VEC];
    *reinterpret_cast<R*>(v) = *reinterpret_cast<const R*>(base + f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] += to_f(v[k]);
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) red[VEC * threadIdx.x + k] = acc[k];
  __syncthreads();
  channel_sums(red, stride, c, part + blk * c);
}

// Phase 3: out = round_T(x * s), walking the tiles from phase 1's last.
template <typename S, int VEC>
__global__ void __launch_bounds__(VEC == 1 ? 1024 : kMaxThreads)
se_apply(const S* __restrict__ x, const float* __restrict__ scale, S* __restrict__ out,
         long long hw, int c, int p_blk, int nb) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  const long long blk = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  const long long e0 = (t.n * hw + t.p0) * c;
  const int len = static_cast<int>(t.p1 - t.p0) * c;
  const int stride = VEC * blockDim.x;
  float sv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sv[k] = scale[t.n * c + (VEC * threadIdx.x + k) % c];
#pragma unroll 4
  for (int f = VEC * threadIdx.x; f < len; f += stride) {
    alignas(sizeof(R)) S v[VEC];
    *reinterpret_cast<R*>(v) = *reinterpret_cast<const R*>(x + e0 + f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = from_f<S>(to_f(v[k]) * sv[k]);
    *reinterpret_cast<R*>(out + e0 + f) = *reinterpret_cast<const R*>(v);
  }
}

template <typename S, int VEC, int MVEC>
int launch(const void* x, void* out, const void* w1, const void* b1, const void* w2t,
           const void* b2, void* part, void* scale, void* s, long long n, long long hw, int c,
           int mid, int threads, int p_blk, int group, cudaStream_t stream) {
  const int nb = static_cast<int>((hw + p_blk - 1) / p_blk);
  const long long blocks = n * nb;
  if (threads < 1 || threads > (VEC == 1 ? 1024 : kMaxThreads) || (VEC * threads) % c ||
      VEC * threads > kRedFloats || (static_cast<long long>(p_blk) * c) % VEC ||
      (hw * c) % VEC || static_cast<long long>(p_blk) * c >= (1LL << 31) ||
      !mlp_fits(c, mid, MVEC, group) || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  se_pool_partials<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<float*>(part), hw, c, p_blk, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_mlp<se_scale_mlp, S, MVEC>(static_cast<const float*>(part), w1, b1, w2t, b2,
                                          static_cast<float*>(scale), s, n, hw, c, mid, nb,
                                          group, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  se_apply<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const float*>(scale), static_cast<S*>(out), hw, c,
      p_blk, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (N, HW, C) channels-last maps of fp32 (bf16 = 0) or bf16 (bf16 = 1);
// w1, w2t: (mid, C) and b1 (mid), b2 (C) in the map dtype; part:
// (N, ceil(HW / p_blk), C) fp32 scratch; scale: (N, C) fp32 scratch; s: (N, C)
// in the map dtype.  vec: elements per vector load, the full 16 bytes (8 bf16,
// 4 fp32) or 1; threads: a block of the pixel passes, with vec * threads a
// multiple of C; the MLP reads 16-byte vectors where C is a multiple of vec.
// Enqueues the three kernels on `stream`; returns the first CUDA error, or 0.
extern "C" int se_scale_launch(int bf16, int vec, const void* x, void* out, const void* w1,
                               const void* b1, const void* w2t, const void* b2, void* part,
                               void* scale, void* s, long long n, long long hw, int c, int mid,
                               int threads, int p_blk, int group, void* stream) {
  if (n <= 0 || hw <= 0) return 0;
  if (c < 1 || p_blk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SE_SCALE_ARGS \
  x, out, w1, b1, w2t, b2, part, scale, s, n, hw, c, mid, threads, p_blk, group, st
  if (bf16) {
    if (vec == 8) {
      return c % 8 == 0 ? launch<uint16_t, 8, 8>(SE_SCALE_ARGS)
                        : launch<uint16_t, 8, 1>(SE_SCALE_ARGS);
    }
    if (vec == 1) return launch<uint16_t, 1, 1>(SE_SCALE_ARGS);
  } else {
    if (vec == 4) {
      return c % 4 == 0 ? launch<float, 4, 4>(SE_SCALE_ARGS) : launch<float, 4, 1>(SE_SCALE_ARGS);
    }
    if (vec == 1) return launch<float, 1, 1>(SE_SCALE_ARGS);
  }
#undef SE_SCALE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
