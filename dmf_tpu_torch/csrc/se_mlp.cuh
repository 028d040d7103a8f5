// The squeeze-excitation MLP shared by the port's two SE kernels: the ResLite
// epilogue (se_epilogue.cu, kernel 1) and the standalone SE (se_scale.cu,
// kernel 6).  Both split a map's pool over (sample, pixel block): a block of
// the first pass writes one fp32 row of per-channel partial sums, (N, nb, C),
// and `epi_mlp` here turns a sample's rows into its scale
//   pool = round_T(sum_rows / HW)
//   h    = round_T(gelu(W1 pool + b1))   fp32 accumulation, exact GELU
//   s    = sigmoid(W2 h + b2)            fp32
// with the rounding points of the TPU kernels (se_pallas.py:112-127,
// epilogue_pallas.py:226-252).  Also here: the element helpers for maps of
// fp32 or bf16 (T); the tile and vector helpers are split_pool.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_pool.cuh"

namespace se_mlp {

using namespace split_pool;

constexpr int kMlpThreads = 256;  // a block of epi_mlp
constexpr int kMaxGroup = 8;      // samples per block of epi_mlp
constexpr int kRows = 4;          // rows of W1 a warp of epi_mlp takes at a time

// element storage: fp32 as float, bf16 as its 16 bits
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
// round an fp32 value to the map dtype and back
template <typename S> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<S>(v));
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// N consecutive floats, as 16-byte vectors where N allows
template <int N>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// slices of the rows that the threads of epi_mlp split between them
__host__ __device__ __forceinline__ int mlp_slices(int vecs) {
  return vecs < kMlpThreads ? kMlpThreads / vecs : 1;
}

// The pool from the partials, then the SE MLP, for `group` samples.  A thread
// takes a vector of VEC channels and a slice of the rows (of the partials,
// then of W2^T); the slices' sums meet in shared memory and are added in a
// fixed order.  W1 is read a row per warp.  Each weight row is read once for
// the group.  The fp32 scale goes to `scale` (N, C); where `s_out` is not
// null, the scale rounded to the map dtype goes there too.  `Caller` is a tag
// type that each SE kernel declares and only names here, so that a profiler
// tells the two kernels' MLP launches apart (se_epilogue_mlp, se_scale_mlp).
template <typename Caller, typename S, int VEC>
__global__ void __launch_bounds__(kMlpThreads)
epi_mlp(const float* __restrict__ part, const S* __restrict__ w1, const S* __restrict__ b1,
        const S* __restrict__ w2t, const S* __restrict__ b2, float* __restrict__ scale,
        S* __restrict__ s_out, long long n_samples, long long hw, int c, int mid, int nb,
        int group) {
  using R = typename Raw<sizeof(S) * VEC>::type;
  extern __shared__ float smem[];
  const int vecs = c / VEC;
  const int slices = mlp_slices(vecs);
  float* pool = smem;                // [group][c]
  float* hid = pool + group * c;     // [group][mid]
  float* red = hid + group * mid;    // [slices][group][c]
  const long long n0 = static_cast<long long>(blockIdx.x) * group;
  const int gn = static_cast<int>(min(static_cast<long long>(group), n_samples - n0));
  const int step = vecs < kMlpThreads ? vecs : kMlpThreads;
  const int slice = vecs < kMlpThreads ? threadIdx.x / vecs : 0;
  const int v0 = threadIdx.x % step;
  const bool sliced = slice < slices;

  // 1. each slice's sum of the partial rows slice, slice + slices, ...
  if (sliced) {
    for (int v = v0; v < vecs; v += step) {
      for (int g = 0; g < gn; ++g) {
        const float* src = part + (n0 + g) * nb * c + v * VEC;
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
#pragma unroll 4
        for (int b = slice; b < nb; b += slices) {
          float t[VEC];
          load_floats<VEC>(src + static_cast<long long>(b) * c, t);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += t[k];
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) red[(slice * group + g) * c + v * VEC + k] = acc[k];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * c; i += blockDim.x) {
    const int g = i / c, ch = i % c;
    float sum = 0.0f;
    for (int sl = 0; sl < slices; ++sl) sum += red[(sl * group + g) * c + ch];
    pool[i] = round_t<S>(sum / static_cast<float>(hw));
  }
  __syncthreads();

  // 2. hidden: a warp takes kRows rows of W1 at a time (rows j, j + warps,
  // ...), so that their loads and reductions overlap
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int j0 = warp; j0 < mid; j0 += kRows * warps) {
    float acc[kRows][kMaxGroup];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) acc[r][g] = 0.0f;
    for (int v = lane; v < vecs; v += 32) {
      alignas(sizeof(R)) S w[kRows][VEC];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = min(j0 + r * warps, mid - 1);  // rows past mid: computed, not stored
        *reinterpret_cast<R*>(w[r]) =
            *reinterpret_cast<const R*>(w1 + static_cast<long long>(j) * c + v * VEC);
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < gn) {
          float t[VEC];
          load_floats<VEC>(pool + g * c + v * VEC, t);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[r][g] += to_f(w[r][k]) * t[k];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r * warps;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < gn) {
          float x = acc[r][g];
          for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane == 0 && j < mid) hid[g * mid + j] = round_t<S>(gelu(x + to_f(b1[j])));
        }
      }
    }
  }
  __syncthreads();

  // 3. scale: each slice's sum over the rows j of W2^T, then the sigmoid
  if (sliced) {
    for (int v = v0; v < vecs; v += step) {
      float acc[kMaxGroup][VEC];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[g][k] = 0.0f;
#pragma unroll 4
      for (int j = slice; j < mid; j += slices) {
        alignas(sizeof(R)) S w[VEC];
        *reinterpret_cast<R*>(w) =
            *reinterpret_cast<const R*>(w2t + static_cast<long long>(j) * c + v * VEC);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < gn) {
            const float h = hid[g * mid + j];
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[g][k] += to_f(w[k]) * h;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < gn)
#pragma unroll
          for (int k = 0; k < VEC; ++k) red[(slice * group + g) * c + v * VEC + k] = acc[g][k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * c; i += blockDim.x) {
    const int g = i / c, ch = i % c;
    float z = to_f(b2[ch]);
    float sum = 0.0f;
    for (int sl = 0; sl < slices; ++sl) sum += red[(sl * group + g) * c + ch];
    z += sum;
    const float s = 1.0f / (1.0f + expf(-z));
    scale[(n0 + g) * c + ch] = s;
    if (s_out != nullptr) s_out[(n0 + g) * c + ch] = from_f<S>(s);
  }
}

// dynamic shared memory of an epi_mlp block: pool, hidden and slice sums
inline size_t mlp_smem_bytes(int c, int mid, int vec, int group) {
  return static_cast<size_t>(group) * ((1 + mlp_slices(c / vec)) * c + mid) * sizeof(float);
}

// whether epi_mlp<., vec> takes these sizes (checked before any launch of a call)
inline bool mlp_fits(int c, int mid, int vec, int group) {
  return c >= 1 && mid >= 1 && c % vec == 0 && group >= 1 && group <= kMaxGroup &&
         mlp_smem_bytes(c, mid, vec, group) <= 227 * 1024;
}

// Enqueues epi_mlp over n samples, `group` to a block; returns the launch's error.
template <typename Caller, typename S, int VEC>
cudaError_t launch_mlp(const float* part, const void* w1, const void* b1, const void* w2t,
                       const void* b2, float* scale, void* s_out, long long n, long long hw,
                       int c, int mid, int nb, int group, cudaStream_t stream) {
  const size_t smem = mlp_smem_bytes(c, mid, VEC, group);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(epi_mlp<Caller, S, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  epi_mlp<Caller, S, VEC>
      <<<static_cast<unsigned>((n + group - 1) / group), kMlpThreads, smem, stream>>>(
      part, static_cast<const S*>(w1), static_cast<const S*>(b1), static_cast<const S*>(w2t),
      static_cast<const S*>(b2), scale, static_cast<S*>(s_out), n, hw, c, mid, nb, group);
  return cudaGetLastError();
}

}  // namespace se_mlp
