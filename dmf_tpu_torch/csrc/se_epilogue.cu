// ResLite-block epilogue SE(dropout(gelu(x + identity))), sm_90a.
//
// Replaces the TPU kernels `_epilogue_kernel` (dmf_tpu/ops/epilogue_pallas.py:222)
// and `_epilogue_kernel_t` (:255), reached through `se_epilogue` (:443).  Built
// by ops/cuda_build.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes (ops/epilogue_cuda.py).
//
// Per sample n of the folded channels-last batch (N, H*W, C), in fp32 or bf16
// (T), with the rounding points of the plain version (ops/epilogue.py):
//   y    = round_T(gelu(x + identity))               add and exact GELU in fp32
//   y    = keep ? round_T(y * round_T(1/(1-p))) : 0  dropout
//   pool = round_T(sum_pixels(y) / HW)              fp32 sum
//   h    = round_T(gelu(W1 pool + b1))              fp32 accumulation
//   s    = sigmoid(W2 h + b2)                       fp32
//   out  = round_T(y * s)
//
// What bounds it on this card: memory traffic.  The MLP is C x C/2 on one
// vector per sample, so there is no tensor-core work; the least traffic is
// two reads and one write of the map.  The pool needs all of a sample's y
// before any output can be scaled, and y does not fit on chip: 67-300 MB at
// the served shapes against 50 MB of L2 and 132 x 227 KB of shared memory.
// So the design is a split reduction over (sample, pixel block), three
// kernels that one C entry point enqueues:
//   1. epi_y_partials, one block per (sample, P pixels): 16-byte vector loads
//      of x and identity (neighbouring threads on neighbouring channels, read
//      as streaming so they leave L2 to y), y written to `out`, and the
//      block's per-channel fp32 sum written as one row of partials (N, nb, C).
//      No atomics: the sum order is fixed, so a result is the same run to run.
//   2. epi_mlp (se_mlp.cuh, shared with the standalone SE of se_scale.cu),
//      one block per G samples: sums the sample's nb partial rows in a fixed
//      order, then pool -> W1 -> GELU -> W2 -> sigmoid into an fp32 scale
//      (N, C), with 16-byte loads of the partials and weights spread over
//      slices of the rows.  Each row of W1 and W2^T is read once per G
//      samples.
//   3. epi_scale, one block per (sample, P pixels): out *= s in place.  It
//      walks the blocks in the reverse of phase 1's order, so that the tiles
//      phase 1 wrote last are read while they are still in L2 (1-3 % faster
//      than the same order on an H100; PERF.md).
// That is 5 passes over the map (2 reads + 1 write, then 1 read + 1 write)
// against the bound's 3: 60 % of the bytes bound is this design's ceiling.
// The partials add 2 x 4 / (P x sizeof(T)) of the map's bytes.
//
// Dropout: Philox4x32-10 (Random123) written into the kernel.  Key = the
// 64-bit seed (lo, hi); counter = (e/4 lo, e/4 hi, 0, 0), where e is `base`
// (a multiple of 4) plus the element's int64 index in the folded
// channels-last batch, so one call gives the bits of 4 neighbouring elements
// and a seed stream's dropout sites each take their own range of counters.
// keep = (bits >> 8) * 2^-24 < 1 - p, exact in fp32.  `keep4` is the one
// keep test: the epilogue and the keep-mask entry point (the seed route's
// dropout outside the epilogue) both call it.  Every offset is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "se_mlp.cuh"

struct se_epilogue_mlp;  // names this kernel's instance of se_mlp::epi_mlp

namespace {

using namespace se_mlp;

constexpr int kThreads = 256;     // a block of phases 1 and 3 while C/VEC <= 256
constexpr int kRedFloats = 2048;  // phase 1's row sums: rows x C <= threads x VEC

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R with R = 10)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 seed_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}

__device__ __forceinline__ unsigned keep_bit(unsigned bits, float keep_prob) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f < keep_prob;  // 2^-24
}

// The keep test of elements 4q .. 4q+3: bit k of the result keeps element 4q+k.
__device__ __forceinline__ unsigned keep4(uint2 key, unsigned long long q, float keep_prob) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<unsigned>(q), static_cast<unsigned>(q >> 32), 0u, 0u), key);
  return keep_bit(r.x, keep_prob) | keep_bit(r.y, keep_prob) << 1 |
         keep_bit(r.z, keep_prob) << 2 | keep_bit(r.w, keep_prob) << 3;
}

// bit k keeps element e + k, k < VEC
template <int VEC>
__device__ __forceinline__ unsigned keep_bits(uint2 key, long long e, float keep_prob) {
  unsigned bits = 0;
  if constexpr (VEC % 4 == 0) {  // e is a multiple of 4 (C % VEC == 0)
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      bits |= keep4(key, static_cast<unsigned long long>(e >> 2) + q, keep_prob) << (4 * q);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const unsigned long long i = static_cast<unsigned long long>(e + k);
      bits |= (keep4(key, i >> 2, keep_prob) >> (i & 3) & 1u) << k;
    }
  }
  return bits;
}

// Phase 1: y -> out, and the block's per-channel fp32 sum -> part[blk].
template <typename S, int VEC>
__global__ void __launch_bounds__(VEC == 1 ? 1024 : kThreads)
epi_y_partials(const S* __restrict__ x, const S* __restrict__ idn, S* __restrict__ out,
               float* __restrict__ part, const long long* __restrict__ seed, long long base,
               long long hw, int c, int p_blk, int nb, float keep_prob, float drop_scale,
               int drop) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  __shared__ float red[kRedFloats];
  const int groups = c / VEC;              // vectors per pixel
  const int rows = blockDim.x / groups;    // pixels per pass
  const int r = threadIdx.x / groups, g = threadIdx.x % groups;
  const long long blk = blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  const uint2 key = drop ? seed_key(seed) : make_uint2(0u, 0u);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  if (r < rows) {
    for (long long p = t.p0 + r; p < t.p1; p += rows) {
      const long long e = (t.n * hw + p) * c + static_cast<long long>(g) * VEC;
      alignas(sizeof(R)) S xv[VEC], iv[VEC], yv[VEC];
      *reinterpret_cast<R*>(xv) = __ldcs(reinterpret_cast<const R*>(x + e));
      *reinterpret_cast<R*>(iv) = __ldcs(reinterpret_cast<const R*>(idn + e));
      const unsigned keep = drop ? keep_bits<VEC>(key, base + e, keep_prob) : ~0u;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float y = round_t<S>(gelu(to_f(xv[k]) + to_f(iv[k])));
        if (drop) y = (keep >> k & 1u) ? round_t<S>(y * drop_scale) : 0.0f;
        yv[k] = from_f<S>(y);
        acc[k] += y;
      }
      *reinterpret_cast<R*>(out + e) = *reinterpret_cast<const R*>(yv);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) red[r * c + g * VEC + k] = acc[k];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s = 0.0f;
    for (int i = 0; i < rows; ++i) s += red[i * c + ch];
    part[blk * c + ch] = s;
  }
}

// Phase 3: out *= s in place, walking the tiles from phase 1's last.
template <typename S, int VEC>
__global__ void __launch_bounds__(VEC == 1 ? 1024 : kThreads)
epi_scale(S* __restrict__ out, const float* __restrict__ scale, long long hw, int c,
          int p_blk, int nb) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  const int groups = c / VEC;
  const int rows = blockDim.x / groups;
  const int r = threadIdx.x / groups, g = threadIdx.x % groups;
  if (r >= rows) return;
  const long long blk = static_cast<long long>(gridDim.x) - 1 - blockIdx.x;
  const Tile t = tile_of(blk, hw, p_blk, nb);
  float sv[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sv[k] = scale[t.n * c + g * VEC + k];
  for (long long p = t.p0 + r; p < t.p1; p += rows) {
    const long long e = (t.n * hw + p) * c + static_cast<long long>(g) * VEC;
    alignas(sizeof(R)) S v[VEC];
    *reinterpret_cast<R*>(v) = *reinterpret_cast<const R*>(out + e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = from_f<S>(to_f(v[k]) * sv[k]);
    *reinterpret_cast<R*>(out + e) = *reinterpret_cast<const R*>(v);
  }
}

__global__ void keep_mask_kernel(int8_t* __restrict__ mask, const long long* __restrict__ seed,
                                 long long base, long long numel, float keep_prob) {
  const uint2 key = seed_key(seed);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < numel;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long e = static_cast<unsigned long long>(base + i);
    mask[i] = static_cast<int8_t>(keep4(key, e >> 2, keep_prob) >> (e & 3) & 1u);
  }
}

// threads of a block of phases 1 and 3: 256, or one per vector of a pixel
// (only VEC = 1 at C > 256)
int row_threads(int groups) { return groups <= kThreads ? kThreads : (groups + 31) / 32 * 32; }

template <typename S, int VEC>
int launch(const void* x, const void* idn, void* out, const void* w1, const void* b1,
           const void* w2t, const void* b2, void* part, void* scale, const void* seed,
           long long base, long long n, long long hw, int c, int mid, int p_blk, int group,
           float keep_prob, float drop_scale, int drop, cudaStream_t stream) {
  const int groups = c / VEC;
  const int threads = row_threads(groups);
  const int nb = static_cast<int>((hw + p_blk - 1) / p_blk);
  const long long blocks = n * nb;
  if (c % VEC || threads > 1024 || (threads / groups) * c > kRedFloats ||
      !mlp_fits(c, mid, VEC, group) || blocks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  epi_y_partials<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(idn), static_cast<S*>(out),
      static_cast<float*>(part), static_cast<const long long*>(seed), base, hw, c, p_blk, nb,
      keep_prob, drop_scale, drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_mlp<se_epilogue_mlp, S, VEC>(static_cast<const float*>(part), w1, b1, w2t, b2,
                                            static_cast<float*>(scale), nullptr, n, hw, c, mid,
                                            nb, group, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  epi_scale<S, VEC><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<S*>(out), static_cast<const float*>(scale), hw, c, p_blk, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, identity, out: (N, HW, C) channels-last maps of fp32 (bf16 = 0) or bf16
// (bf16 = 1); w1, w2t: (mid, C) and b1 (mid), b2 (C) in the map dtype; part:
// (N, ceil(HW / p_blk), C) fp32 scratch; scale: (N, C) fp32 scratch; seed: one
// int64 on the device, read only when `drop`; base: the Philox counter of the
// batch's first element, a multiple of 4.  vec: elements per vector load,
// the full 16 bytes (8 bf16, 4 fp32; C a multiple, 16-byte aligned maps) or 1.
// Enqueues the three kernels on `stream`; returns the first CUDA error, or 0.
extern "C" int se_epilogue_launch(int bf16, int vec, const void* x, const void* idn, void* out,
                                  const void* w1, const void* b1, const void* w2t,
                                  const void* b2, void* part, void* scale, const void* seed,
                                  long long base, long long n, long long hw, int c, int mid,
                                  int p_blk, int group, float keep_prob, float drop_scale,
                                  int drop, void* stream) {
  if (n <= 0 || hw <= 0) return 0;
  if (base < 0 || base % 4) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SE_EPILOGUE_ARGS \
  x, idn, out, w1, b1, w2t, b2, part, scale, seed, base, n, hw, c, mid, p_blk, group, keep_prob, \
      drop_scale, drop, s
  if (bf16) {
    if (vec == 8) return launch<uint16_t, 8>(SE_EPILOGUE_ARGS);
    if (vec == 1) return launch<uint16_t, 1>(SE_EPILOGUE_ARGS);
  } else {
    if (vec == 4) return launch<float, 4>(SE_EPILOGUE_ARGS);
    if (vec == 1) return launch<float, 1>(SE_EPILOGUE_ARGS);
  }
#undef SE_EPILOGUE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask[i] = the epilogue's keep bit of element base + i of the folded batch,
// for `seed` (one int64 on the device) and keep probability keep_prob.
extern "C" int keep_mask_launch(void* mask, const void* seed, long long base, long long numel,
                                float keep_prob, void* stream) {
  if (numel <= 0) return 0;
  const long long want = (numel + kThreads - 1) / kThreads;
  const long long blocks = want < 65536 ? want : 65536;
  keep_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(mask), static_cast<const long long*>(seed), base, numel, keep_prob);
  return static_cast<int>(cudaGetLastError());
}
