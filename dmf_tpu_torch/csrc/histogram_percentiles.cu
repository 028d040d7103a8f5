// Per-row percentiles from a 4096-bin histogram (Nyul landmarks), sm_90a.
//
// Replaces the TPU kernel `_percentile_kernel` (dmf_tpu/ops/histogram_pallas.py:38),
// reached through `histogram_percentiles_pallas` (:120) and
// `nyul_transform_pallas` (:157).  Built by ops/cuda_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes
// (ops/histogram.py).
//
// Computes exactly what the TPU kernel computes (:40-116), per row of P fp32
// values (one row = one (image, channel)):
//   1. mn, mx of the row; span = max(mx - mn, 1e-12);
//   2. bin = floor(clip((x - mn) / span * 4096, 0, 4095)) per value, counted
//      into a 4096-bin histogram;
//   3. the inclusive CDF over the bins;
//   4. per percent p: tgt = p/100 * (P - 1) + 1, bin = #(cdf < tgt) clipped
//      to [0, 4095], c_hi = cdf[bin], c_lo = cdf[bin - 1] (0 for bin 0),
//      frac = clip((tgt - c_lo) / max(c_hi - c_lo, 1), 0, 1),
//      value = mn + (bin + frac) / 4096 * span.
// Every step uses the _rn intrinsics in that order, so nvcc contracts nothing
// into an FMA and the bins agree with the plain PyTorch version
// (histogram_percentiles_ref) value for value.
//
// What bounds it on this card: one read of the rows, at 3.35 TB/s (DCE at
// B=8: 48 rows of 65536, 12.6 MB, 3.8 us).  The TPU kernel built the
// histogram with one-hot matmuls on the MXU and the CDF with triangular
// matmuls, because Mosaic has no scatter; Hopper has shared-memory atomics,
// so the design is the plain one:
//   * one block of 256 threads per row, a 16 KB int32 histogram in shared
//     memory;
//   * a min/max pass over the row, then the counting pass (the second read
//     of a 256 KB row mostly hits L2);
//   * a block scan of the 4096 bins (16 per thread) for the CDF, kept in the
//     same shared array;
//   * the readout by one warp per percent, each lane counting cdf < tgt over
//     128 bins.
// What limits it in practice: shared-memory atomic contention where many
// values share a bin (background pixels), and at G = 48 rows only 48 of the
// 132 SMs have a block.  Counts are exact in int32; the CDF is compared as
// fp32, exact while P < 2^24 (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 4096;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBinsPerThread = kBins / kThreads;
static_assert(kBins % kThreads == 0, "bins split evenly over threads");
static_assert(kBins * sizeof(int) <= 48 * 1024, "histogram fits static shared memory");

__global__ void __launch_bounds__(kThreads)
histogram_percentiles_kernel(const float* __restrict__ x, const float* __restrict__ pct,
                             float* __restrict__ out, int64_t P, int L) {
  __shared__ int hist[kBins];
  __shared__ float red_mn[kWarps];
  __shared__ float red_mx[kWarps];
  __shared__ int scan[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = x + static_cast<int64_t>(blockIdx.x) * P;

  // 1. min and max of the row
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = tid; i < P; i += kThreads) {
    const float v = row[i];
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (lane == 0) {
    red_mn[warp] = mn;
    red_mx[warp] = mx;
  }
  for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
  mn = red_mn[0];
  mx = red_mx[0];
  for (int w = 1; w < kWarps; ++w) {
    mn = fminf(mn, red_mn[w]);
    mx = fmaxf(mx, red_mx[w]);
  }
  const float span = fmaxf(__fsub_rn(mx, mn), 1e-12f);

  // 2. the histogram
  for (int64_t i = tid; i < P; i += kThreads) {
    float t = __fmul_rn(__fdiv_rn(__fsub_rn(row[i], mn), span), static_cast<float>(kBins));
    t = fminf(fmaxf(t, 0.0f), static_cast<float>(kBins - 1));
    atomicAdd(&hist[static_cast<int>(floorf(t))], 1);
  }
  __syncthreads();

  // 3. inclusive CDF: thread t owns bins [16 t, 16 t + 16)
  const int first = tid * kBinsPerThread;
  int local[kBinsPerThread];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) {
    sum += hist[first + k];
    local[k] = sum;
  }
  int incl = sum;  // inclusive scan of the per-thread sums within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? scan[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < kWarps) scan[lane] = v;
  }
  __syncthreads();
  const int offset = incl - sum + (warp > 0 ? scan[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kBinsPerThread; ++k) hist[first + k] = local[k] + offset;
  __syncthreads();

  // 4. readout, one warp per percent
  const float pm1 = static_cast<float>(P - 1);
  for (int l = warp; l < L; l += kWarps) {
    const float tgt = __fadd_rn(__fmul_rn(pct[l], pm1), 1.0f);
    int cnt = 0;
    for (int b = lane; b < kBins; b += 32) cnt += static_cast<float>(hist[b]) < tgt;
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lane == 0) {
      const int bin = min(max(cnt, 0), kBins - 1);
      const float c_hi = static_cast<float>(hist[bin]);
      const float c_lo = bin > 0 ? static_cast<float>(hist[bin - 1]) : 0.0f;
      float frac = __fdiv_rn(__fsub_rn(tgt, c_lo), fmaxf(__fsub_rn(c_hi, c_lo), 1.0f));
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      const float pos = __fdiv_rn(__fadd_rn(static_cast<float>(bin), frac),
                                  static_cast<float>(kBins));
      out[static_cast<int64_t>(blockIdx.x) * L + l] = __fadd_rn(mn, __fmul_rn(pos, span));
    }
  }
}

}  // namespace

// x: (G, P) fp32 rows, contiguous; pct: (L,) fp32 fractions p/100; out: (G, L)
// fp32.  Launches on `stream` and returns cudaGetLastError().
extern "C" int histogram_percentiles_launch(const void* x, const void* pct, void* out,
                                            long long G, long long P, int L,
                                            void* stream) {
  if (G <= 0 || L <= 0) return 0;
  histogram_percentiles_kernel<<<static_cast<unsigned>(G), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pct),
      static_cast<float*>(out), static_cast<int64_t>(P), L);
  return static_cast<int>(cudaGetLastError());
}
