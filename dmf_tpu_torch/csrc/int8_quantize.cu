// Per-tensor int8 activation quantization, sm_90a: the static quantize, and
// the dynamic quantize (abs-max, scale and quantize in one launch).
//
// Replace no Pallas kernel: the JAX package's `_static_quantize` and
// `_dynamic_quantize` (dmf_tpu/ops/quant.py:76-94) are XLA's reduce and
// elementwise fusions.  They feed the int8 conv (csrc/int8_conv.cu), which
// reads int8.  Built by ops/cuda_build.py with nvcc into a shared library with
// a plain C interface, loaded with ctypes (ops/quant_cuda.py).
//
//   static:  q = clip(rne(x * rcp(scale)), -127, 127)                  quant.py:93
//   dynamic: scale = max(max|x|, 1e-12) / 127,
//            q = clip(rne(x / scale), -127, 127)                       quant.py:84-86
// with x fp32 or bf16 (upcast exactly), IEEE operations throughout
// (__frcp_rn, __fdiv_rn, __fmul_rn; the build has no fast-math) and
// round-half-to-even (__float2int_rn), as jnp.round and torch.round.  The
// clamp is to +-127: -128 never occurs.  The two roundings differ on some
// inputs (x * rcp(scale) against x / scale), so each route keeps its own.
//
// quantize_kernel (static; also the division form, `divide`): a grid-stride
// loop, 4 elements a thread a step.  Bound by one read of x and one write of
// the int8 copy.
//
// dynamic_quantize_kernel: the max over the whole tensor must be known before
// the first element is quantized, so x is read twice; what bounds it is
// those bytes, 2 reads of x and 1 write of the int8 copy in the worst case,
// 1 read and 1 write where the second read hits L2, and the IEEE division,
// some 10 instructions an element.  The design:
//   * one cooperative launch of a persistent grid, as many blocks as fit on
//     the card at once (occupancy x SMs), fewer for a small tensor; no
//     memset, no scalar launches around it;
//   * pass 1: each block owns one contiguous span of 16-element units (one
//     16-byte int8 store each: 2 16-byte loads of bf16, 4 of fp32) and folds
//     the bits of |x| with an unsigned max, 8 independent 16-byte loads in
//     flight a thread.  For non-negative floats the bits' order is the
//     values' and any NaN lies above +inf, so the max keeps NaN, as jnp.max
//     and torch.amax do (fmaxf would drop it).  bf16 pairs fold in 16-bit
//     lanes (__vmaxu2);
//   * each block writes its partial to a workspace slot (every slot is
//     written, so it needs no zeroing), then cooperative_groups'
//     grid.sync();
//   * every block reads the partials (a few hundred words) and computes the
//     scale itself; block 0 stores it;
//   * pass 2: each block walks its own span from the end back to the start,
//     so that the lines it read last in pass 1, the likeliest still in L2,
//     are read first, and writes 16 codes a thread with one 16-byte store.
// A tensor or output not 16-byte aligned takes the same kernel element by
// element; the last n % 16 elements of an aligned one are block 0's.
// On an H100 the inputs past L2 run at ~82 % of the two-read bound: pass 2
// finds little of x in L2.  L2 eviction hints (pass 1 keeping the lines pass
// 2 reads first at normal priority, the rest and pass 2 evict-first) made the
// int8 request's inputs ~2 % slower, and are not used.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

unsigned blocks_for(long long n, int vec) {
  const long long want = (n / vec + kThreads - 1) / kThreads;
  return static_cast<unsigned>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
}

// ------------------------------------------------------------ dynamic route
// The bits of |v| as fp32 bits: unsigned order is the order of |v|, any NaN
// above +inf.
__device__ __forceinline__ unsigned abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ unsigned abs_bits(__nv_bfloat16 v) {
  return (static_cast<unsigned>(__bfloat16_as_ushort(v)) & 0x7fffu) << 16;
}

// One 16-byte vector folded into the running max: fp32 in fp32 bits, bf16
// in two 16-bit lanes of bf16 bits (lane_bits turns those into fp32 bits).
__device__ __forceinline__ unsigned fold(unsigned m, uint4 v, float) {
  m = max(m, v.x & 0x7fffffffu);
  m = max(m, v.y & 0x7fffffffu);
  m = max(m, v.z & 0x7fffffffu);
  return max(m, v.w & 0x7fffffffu);
}
__device__ __forceinline__ unsigned fold(unsigned m, uint4 v, __nv_bfloat16) {
  m = __vmaxu2(m, v.x & 0x7fff7fffu);
  m = __vmaxu2(m, v.y & 0x7fff7fffu);
  m = __vmaxu2(m, v.z & 0x7fff7fffu);
  return __vmaxu2(m, v.w & 0x7fff7fffu);
}
__device__ __forceinline__ unsigned lane_bits(unsigned m, float) { return m; }
__device__ __forceinline__ unsigned lane_bits(unsigned m, __nv_bfloat16) {
  return max(m >> 16, m & 0xffffu) << 16;
}

__device__ __forceinline__ unsigned code(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return static_cast<unsigned>(max(-127, min(127, q))) & 0xffu;
}
__device__ __forceinline__ unsigned code4(float a, float b, float c, float d, float scale) {
  return code(a, scale) | (code(b, scale) << 8) | (code(c, scale) << 16) | (code(d, scale) << 24);
}
// the 4 int8 codes of one 32-bit word's worth of output
__device__ __forceinline__ unsigned codes_f32(uint4 v, float scale) {
  return code4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
               __uint_as_float(v.w), scale);
}
__device__ __forceinline__ unsigned codes_bf16(unsigned a, unsigned b, float scale) {
  return code4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
               __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u), scale);
}

template <typename T, bool VEC>
struct Dyn {
  // elements a unit: one 16-byte int8 store (VEC), else one element
  static constexpr int kElems = VEC ? 16 : 1;
  // 16-byte loads a unit (VEC)
  static constexpr int kLoads = VEC ? 16 * static_cast<int>(sizeof(T)) / 16 : 1;
  // units a thread takes a step: 8 independent loads in flight
  static constexpr int kUnits = 8 / kLoads;
  static constexpr long long kStep = static_cast<long long>(kUnits) * kThreads;
};

__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    dynamic_quantize_kernel(const T* __restrict__ x, long long n, unsigned* __restrict__ partial,
                            float* __restrict__ scale_out, int8_t* __restrict__ out) {
  using D = Dyn<T, VEC>;
  __shared__ unsigned warp_max[2][kThreads / 32];
  const int tid = threadIdx.x;
  const long long n_units = n / D::kElems;
  const long long per = (n_units + gridDim.x - 1) / gridDim.x;
  const long long begin = min(n_units, static_cast<long long>(blockIdx.x) * per);
  const long long end = min(n_units, begin + per);
  const long long steps = (end - begin + D::kStep - 1) / D::kStep;
  const long long tail = n_units * D::kElems;  // block 0 takes [tail, n)
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  // pass 1: max |x| over the block's span
  unsigned m = 0;
  for (long long s = 0; s < steps; ++s) {
    const long long u0 = begin + s * D::kStep + tid;
    if constexpr (VEC) {
      uint4 r[D::kUnits][D::kLoads];
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
#pragma unroll
        for (int l = 0; l < D::kLoads; ++l)
          r[j][l] = u < end ? xv[u * D::kLoads + l] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j)
#pragma unroll
        for (int l = 0; l < D::kLoads; ++l) m = fold(m, r[j][l], T());
    } else {
      T r[D::kUnits];
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
        r[j] = u < end ? x[u] : T();
      }
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) m = max(m, abs_bits(r[j]));
    }
  }
  if constexpr (VEC) m = lane_bits(m, T());
  if (blockIdx.x == 0 && tail + tid < n) m = max(m, abs_bits(x[tail + tid]));
  m = block_max(m, warp_max[0]);
  if (tid == 0) partial[blockIdx.x] = m;

  cg::this_grid().sync();

  // the scale, in every block: max(amax, 1e-12) / 127, NaN kept (as
  // jnp.maximum and torch.clamp_min)
  unsigned a = 0;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads) a = max(a, __ldcg(partial + i));
  a = block_max(a, warp_max[1]);
  const float amax = __uint_as_float(a);
  const float scale = __fdiv_rn(amax != amax ? amax : fmaxf(amax, 1e-12f), 127.0f);
  if (blockIdx.x == 0 && tid == 0) *scale_out = scale;

  // pass 2: the span from its end back to its start
  for (long long s = steps - 1; s >= 0; --s) {
    const long long u0 = begin + s * D::kStep + tid;
    if constexpr (VEC) {
      uint4 r[D::kUnits][D::kLoads];
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
#pragma unroll
        for (int l = 0; l < D::kLoads; ++l)
          r[j][l] = u < end ? xv[u * D::kLoads + l] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
        if (u >= end) continue;
        uint4 q;
        if constexpr (sizeof(T) == 4) {
          q = make_uint4(codes_f32(r[j][0], scale), codes_f32(r[j][1], scale),
                         codes_f32(r[j][2], scale), codes_f32(r[j][3], scale));
        } else {
          q = make_uint4(codes_bf16(r[j][0].x, r[j][0].y, scale),
                         codes_bf16(r[j][0].z, r[j][0].w, scale),
                         codes_bf16(r[j][1].x, r[j][1].y, scale),
                         codes_bf16(r[j][1].z, r[j][1].w, scale));
        }
        reinterpret_cast<uint4*>(out)[u] = q;
      }
    } else {
      T r[D::kUnits];
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
        r[j] = u < end ? x[u] : T();
      }
#pragma unroll
      for (int j = 0; j < D::kUnits; ++j) {
        const long long u = u0 + j * kThreads;
        if (u < end) out[u] = static_cast<int8_t>(code(upcast(r[j]), scale));
      }
    }
  }
  if (blockIdx.x == 0 && tail + tid < n)
    out[tail + tid] = static_cast<int8_t>(code(upcast(x[tail + tid]), scale));
}

const void* dynamic_kernel(int dtype, int vec) {
  if (dtype == 0 && vec) return reinterpret_cast<const void*>(&dynamic_quantize_kernel<float, true>);
  if (dtype == 0) return reinterpret_cast<const void*>(&dynamic_quantize_kernel<float, false>);
  if (dtype == 1 && vec)
    return reinterpret_cast<const void*>(&dynamic_quantize_kernel<__nv_bfloat16, true>);
  if (dtype == 1) return reinterpret_cast<const void*>(&dynamic_quantize_kernel<__nv_bfloat16, false>);
  return nullptr;
}

// elements one step of a block covers
long long dynamic_step(int dtype, int vec) {
  if (!vec) return Dyn<float, false>::kStep;
  return dtype == 0 ? Dyn<float, true>::kStep * 16 : Dyn<__nv_bfloat16, true>::kStep * 16;
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

// The dynamic quantize's co-resident blocks on the current device (its SMs x
// the blocks of 256 threads an SM holds at once), the size of the partials'
// workspace; a negative CUDA error on failure.
extern "C" int int8_dynamic_quantize_capacity(int dtype, int vec) {
  const void* fn = dynamic_kernel(dtype, vec);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * per_sm;
}

// dtype: 0 fp32, 1 bf16.  vec: 1 where x and out are 16-byte aligned, else 0.
// partial: `capacity` unsigned words (int8_dynamic_quantize_capacity), no
// initial value needed.  scale: a device fp32 scalar, written.  out: n int8.
extern "C" int int8_dynamic_quantize_launch(int dtype, int vec, const void* x, long long n,
                                            void* partial, int capacity, void* scale, void* out,
                                            void* stream) {
  const void* fn = dynamic_kernel(dtype, vec);
  if (fn == nullptr || n <= 0 || capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long step = dynamic_step(dtype, vec);
  const long long want = (n + step - 1) / step;
  const unsigned grid = static_cast<unsigned>(want < capacity ? want : capacity);
  void* args[] = {&x, &n, &partial, &scale, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                                      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
