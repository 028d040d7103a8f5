// Per-tensor int8 activation quantization and its abs-max, sm_90a.
//
// Replace no Pallas kernel: the JAX package's `_static_quantize` and
// `_dynamic_quantize` (dmf_tpu/ops/quant.py:78-94) are elementwise XLA
// fusions.  They feed the int8 conv (csrc/int8_conv.cu), which reads int8.
// Built by ops/cuda_build.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes (ops/quant_cuda.py).
//
//   quantize (static):  q = clip(rne(x * rcp(scale)), -127, 127)   quant.py:93
//   quantize (dynamic): q = clip(rne(x / scale), -127, 127)         quant.py:84-86
//   abs_max:            max |x| over the tensor (fp32)              quant.py:84
// with x fp32 or bf16 (upcast exactly), IEEE operations throughout
// (__frcp_rn, __fdiv_rn, __fmul_rn; the build has no fast-math) and
// round-half-to-even (__float2int_rn), as jnp.round and torch.round.  The
// clamp is to +-127: -128 never occurs.  The max is taken with an atomicMax
// on the bits of non-negative floats, whose order is the floats' order, so
// the result does not depend on the order the blocks finish in.
//
// What bounds them on this card: memory traffic, one read of x and one
// write of the int8 copy (quantize), one read (abs_max).  A thread takes
// 4 elements a step (a 16-byte fp32 or 8-byte bf16 load and a 4-byte store)
// where the tensor is aligned, in a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float upcast(float v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quantize1(float v, float scale, float rcp, int divide) {
  const float t = divide ? __fdiv_rn(v, scale) : __fmul_rn(v, rcp);
  const int q = __float2int_rn(t);
  return static_cast<int8_t>(max(-127, min(127, q)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale_p, int divide,
                    int8_t* __restrict__ out, long long n) {
  const float scale = *scale_p;
  const float rcp = __frcp_rn(scale);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n_vec = n / VEC;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n_vec;
       i += stride) {
    if constexpr (VEC == 4) {
      float v[4];
      if constexpr (sizeof(T) == 4) {
        const float4 f = reinterpret_cast<const float4*>(x)[i];
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
        const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        v[0] = __low2float(lo); v[1] = __high2float(lo);
        v[2] = __low2float(hi); v[3] = __high2float(hi);
      }
      char4 q;
      q.x = quantize1(v[0], scale, rcp, divide);
      q.y = quantize1(v[1], scale, rcp, divide);
      q.z = quantize1(v[2], scale, rcp, divide);
      q.w = quantize1(v[3], scale, rcp, divide);
      reinterpret_cast<char4*>(out)[i] = q;
    } else {
      out[i] = quantize1(upcast(x[i]), scale, rcp, divide);
    }
  }
  // the tail past the last whole vector
  if (blockIdx.x == 0) {
    for (long long i = n_vec * VEC + threadIdx.x; i < n; i += kThreads)
      out[i] = quantize1(upcast(x[i]), scale, rcp, divide);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    abs_max_kernel(const T* __restrict__ x, long long n, unsigned* __restrict__ out) {
  __shared__ float warp_max[kThreads / 32];
  float m = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n_vec = n / VEC;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n_vec;
       i += stride) {
    if constexpr (VEC == 4) {
      if constexpr (sizeof(T) == 4) {
        const float4 f = reinterpret_cast<const float4*>(x)[i];
        m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
      } else {
        const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(__low2float(lo)), fabsf(__high2float(lo))),
                           fmaxf(fabsf(__low2float(hi)), fabsf(__high2float(hi)))));
      }
    } else {
      m = fmaxf(m, fabsf(upcast(x[i])));
    }
  }
  if (blockIdx.x == 0) {
    for (long long i = n_vec * VEC + threadIdx.x; i < n; i += kThreads)
      m = fmaxf(m, fabsf(upcast(x[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) atomicMax(out, __float_as_uint(m));
  }
}

unsigned blocks_for(long long n, int vec) {
  const long long want = (n / vec + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  vec: 4 where x is 16-byte (fp32) / 8-byte (bf16)
// aligned and out 4-byte aligned, else 1.  scale: a device fp32 scalar.
extern "C" int int8_quantize_launch(int dtype, int vec, const void* x, const void* scale,
                                    int divide, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  const unsigned blocks = blocks_for(n, vec);
  if (dtype == 0 && vec == 4)
    quantize_kernel<float, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), s, divide, o, n);
  else if (dtype == 0 && vec == 1)
    quantize_kernel<float, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), s, divide, o, n);
  else if (dtype == 1 && vec == 4)
    quantize_kernel<__nv_bfloat16, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, divide, o, n);
  else if (dtype == 1 && vec == 1)
    quantize_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), s, divide, o, n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out: a device fp32 scalar, set to 0 here, then raised to max |x|.
extern "C" int int8_abs_max_launch(int dtype, int vec, const void* x, void* out, long long n,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), st);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  unsigned* o = static_cast<unsigned*>(out);
  const unsigned blocks = blocks_for(n, vec);
  if (dtype == 0 && vec == 4)
    abs_max_kernel<float, 4><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x), n, o);
  else if (dtype == 0 && vec == 1)
    abs_max_kernel<float, 1><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x), n, o);
  else if (dtype == 1 && vec == 4)
    abs_max_kernel<__nv_bfloat16, 4><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, o);
  else if (dtype == 1 && vec == 1)
    abs_max_kernel<__nv_bfloat16, 1><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, o);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
