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
// matmuls, because Mosaic has no scatter.  Here one thread-block cluster of
// kCluster = 8 blocks (portable size) takes a row, block r a contiguous slice
// of ceil(P / 8) values, so that 48 rows already give 384 blocks:
//   * the slice comes into shared memory once, by bulk copies
//     (cp.async.bulk) in kChunks pieces on their own mbarriers, and its min
//     and max are folded as the pieces land; the unaligned head and tail of
//     a slice (at most 3 values each, rows start at g * P * 4 bytes) take
//     plain loads.  The grid holds no more clusters than the card keeps
//     resident (cudaOccupancyMaxActiveClusters); a cluster walks rows g,
//     g + clusters, ..., and starts the copies of its next row's slices as
//     soon as the current ones are binned, so that they land during the
//     merge and the readout;
//   * cluster barrier 1: every block reads the 8 slice minima and maxima
//     through distributed shared memory (DSMEM) and folds them, so all hold
//     the same mn and span;
//   * the slice is binned from shared memory into the block's own 16 KB
//     int32 histogram, one shared atomicAdd of 1 a value; each block also
//     sums its histogram over the 8 ranges of 512 bins (one warp a range).
//     Rows with 60 % of their values in one bin (a breast slice's
//     background) take within 6 % of the time of spread-out rows (phase 3f
//     of chip_smoke.py): the card appears to merge a warp's increments of
//     one address.  Aggregating a warp's equal bins first
//     (__match_any_sync) measured slower on both kinds of row; 16-bit
//     counts packed two to a word (4 blocks an SM became 5) slowed crowded
//     rows down, their adds of 1 or 2^16 not being merged;
//   * cluster barrier 2: block r owns bins [512 r, 512 r + 512); it sums them
//     over the 8 histograms in rank order (a reduce-scatter over DSMEM) and
//     takes its prefix (the count below bin 512 r) from the other blocks'
//     range sums;
//   * cluster barrier 3 is split: a block arrives once it has read the
//     others' shared memory, scans its 512 bins into CDF values and reads
//     out every percent whose bin it owns, and waits only at the end of the
//     row (its histogram must outlive the others' reads).  The CDF is
//     monotone, so the bin of a target lies in slice r exactly when
//     cdf[512 r - 1] < tgt <= cdf[512 r + 511]; the last block also owns the
//     clipped count 4096.  One block writes each output.
// Rows whose slice does not fit the shared-memory budget (kSliceFloats =
// 24576 values, 96 KB, i.e. P > 196608) stream their slice from global memory
// twice instead, min/max then bins; the second read mostly hits L2.
//
// The division: t = (x - mn) / span * 4096 is taken as
// (x - mn) * (4096 rcp(span)), with rcp the correctly rounded reciprocal
// (the factor 4096 is exact); it differs from the IEEE quotient's t by less
// than 4096 * 3 * 2^-24 < 2^-10 (x - mn <= span, every product rounded once),
// so where it lies further than kEdge = 2^-9 from every integer k >= 1 both
// give the same bin (below 1 both give bin 0).  Where one of a thread's four
// values lies within kEdge of such an integer, the IEEE quotient
// (__fdiv_rn) decides all four, as
// it does for every value of a row whose span is above 2^125 (there the
// reciprocal is subnormal).  floor(t) is read from the bits of t + 2^23
// rounded down, and the nearest integer from t + 2^23 rounded to nearest:
// full-rate adds instead of conversion instructions.
//
// Counts are exact in int32; the CDF is compared as fp32, exact while
// P < 2^24 (the wrapper checks).  Atomics give the same counts in any order,
// so two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 4096;
constexpr int kCluster = 8;
constexpr int kOwn = kBins / kCluster;  // bins each block of a cluster owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;
constexpr long long kSliceFloats = 24576;  // the shared-memory budget of a slice
constexpr int kHistBytes = kBins * static_cast<int>(sizeof(int));
constexpr int kMaxSmem = kHistBytes + static_cast<int>(kSliceFloats) * 4;
constexpr float kEdge = 1.0f / 512.0f;
static_assert(kOwn == 2 * kThreads, "two owned bins a thread");
static_assert(kWarps == kCluster, "one warp sums each block's range of bins");
static_assert(kOwn == 32 * 16, "a warp's range is 16 bins a lane");

// floor(t) for 0 <= t < 2^23, clipped to the last bin, from the bits of
// t + 2^23 rounded down (an add at the full rate, no conversion instruction);
// NaN and infinity land in the last bin
__device__ __forceinline__ int floor_bin(float t) {
  const unsigned b = static_cast<unsigned>(__float_as_int(__fadd_rd(t, 0x1p23f)) - 0x4B000000);
  return static_cast<int>(min(b, static_cast<unsigned>(kBins - 1)));
}

// t = (v - mn) / span * 4096 as the plain version rounds it
__device__ __forceinline__ float t_exact(float v, float mn, float span) {
  return __fmul_rn(__fdiv_rn(__fsub_rn(v, mn), span), static_cast<float>(kBins));
}

// t from `rcp4096` = 4096 rcp(span); `near` is set where it lies within
// kEdge of an integer k >= 1 (near 0 both round down to bin 0)
__device__ __forceinline__ float t_fast(float v, float mn, float rcp4096, bool& near) {
  const float t = __fmul_rn(__fsub_rn(v, mn), rcp4096);
  const float k = __fsub_rn(__fadd_rn(t, 0x1p23f), 0x1p23f);  // the nearest integer
  near |= fabsf(__fsub_rn(t, k)) < kEdge && k >= 1.0f;
  return t;
}

__device__ __forceinline__ void fold(float4 v, float& mn, float& mx) {
  mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
  mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
}

// Block r's slice of row g: up to 3 values ahead of the 16-byte aligned
// float4s of its body, up to 3 after them (rows start at g * P * 4 bytes).
struct Slice {
  const float* src;
  int head, body4, tail;
  __device__ const float4* body() const { return reinterpret_cast<const float4*>(src + head); }
  __device__ int chunk4() const { return (body4 + kChunks - 1) / kChunks; }
};

__device__ __forceinline__ Slice slice_of(const float* x, long long g, long long P, long long S,
                                          int r) {
  const long long lo = min(static_cast<long long>(r) * S, P);
  Slice s;
  s.src = x + g * P + lo;
  const int n = static_cast<int>(min(lo + S, P) - lo);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(s.src) >> 2) & 3);
  s.head = min((4 - mis) & 3, n);
  s.body4 = (n - s.head) >> 2;
  s.tail = n - s.head - 4 * s.body4;
  return s;
}

// Thread 0 starts the bulk copies of a slice's body into `buf`, one piece on
// each chunk barrier.
__device__ __forceinline__ void load_slice(const Slice& s, float4* buf, uint64_t* bars) {
  hopper::fence_proxy_async();  // the earlier reads of buf come first
  const int chunk4 = s.chunk4();
  for (int c = 0; c < kChunks; ++c) {
    const int cnt = min(chunk4, s.body4 - c * chunk4);
    if (cnt <= 0) break;
    hopper::mbar_arrive_expect_tx(&bars[c], static_cast<uint32_t>(cnt) * 16u);
    hopper::bulk_load(buf + c * chunk4, s.body() + c * chunk4, static_cast<uint32_t>(cnt) * 16u,
                      &bars[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
histogram_percentiles_cluster(const float* __restrict__ x, const float* __restrict__ pct,
                              float* __restrict__ out, long long G, long long P, int L,
                              long long S, int fits) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  float4* buf = reinterpret_cast<float4*>(smem + kHistBytes);    // the slice's body
  __shared__ uint64_t bars[kChunks];
  __shared__ float warp_mn[kWarps], warp_mx[kWarps];
  __shared__ float slice_mn, slice_mx;
  __shared__ __align__(16) int range_sum[kCluster];  // this block's counts in each owner's bins
  __shared__ int scan[kWarps];
  __shared__ int cdf[kOwn];  // the CDF at bins 512 r .. 512 r + 511
  __shared__ int prefix_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int r = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long n_clusters = gridDim.x / kCluster;
  if (tid == 0) {
    for (int c = 0; c < kChunks; ++c) hopper::mbar_init(&bars[c], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  uint32_t phases = 0;  // each chunk barrier's phase parity

  long long g = blockIdx.x / kCluster;
  Slice sl = slice_of(x, g, P, S, r);
  if (fits && tid == 0) load_slice(sl, buf, bars);
  for (; g < G; g += n_clusters) {
    const float* src = sl.src;
    const int head = sl.head, body4 = sl.body4, tail = sl.tail;
    const float4* gbody = sl.body();
    const int chunk4 = sl.chunk4();
    // the head and the tail, one value a thread (threads 0-2 and 4-6)
    float extra = 0.0f;
    bool has_extra = false;
    if (tid < head) {
      extra = src[tid];
      has_extra = true;
    } else if (tid >= 4 && tid < 4 + tail) {
      extra = src[head + 4 * body4 + tid - 4];
      has_extra = true;
    }
    float mn = has_extra ? extra : INFINITY;
    float mx = has_extra ? extra : -INFINITY;
    for (int b = tid; b < kBins / 4; b += kThreads)
      reinterpret_cast<int4*>(hist)[b] = make_int4(0, 0, 0, 0);

    // 1. min and max of the slice, as its chunks land
    if (fits) {
      for (int c = 0; c < kChunks; ++c) {
        const int base = c * chunk4;
        const int cnt = min(chunk4, body4 - base);
        if (cnt <= 0) break;
        hopper::mbar_wait(&bars[c], (phases >> c) & 1u);
        phases ^= 1u << c;
        for (int i = tid; i < cnt; i += kThreads) fold(buf[base + i], mn, mx);
      }
    } else {
      for (int i = tid; i < body4; i += kThreads) fold(__ldg(gbody + i), mn, mx);
    }
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      warp_mn[warp] = mn;
      warp_mx[warp] = mx;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        mn = fminf(mn, warp_mn[w]);
        mx = fmaxf(mx, warp_mx[w]);
      }
      slice_mn = mn;
      slice_mx = mx;
    }
    cluster.sync();  // 1: every slice's min and max published

    mn = INFINITY;
    mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {  // rank order; min and max are exact
      mn = fminf(mn, *cluster.map_shared_rank(&slice_mn, q));
      mx = fmaxf(mx, *cluster.map_shared_rank(&slice_mx, q));
    }
    const float span = fmaxf(__fsub_rn(mx, mn), 1e-12f);
    const float rcp4096 = __fmul_rn(__frcp_rn(span), static_cast<float>(kBins));
    const bool fast = span <= 0x1p125f;

    // 2. the slice's histogram, from shared memory
    if (has_extra) atomicAdd(&hist[floor_bin(t_exact(extra, mn, span))], 1);
#pragma unroll 2
    for (int i = tid; i < body4; i += kThreads) {
      const float4 v = fits ? buf[i] : __ldg(gbody + i);
      bool near = !fast;
      float t0 = t_fast(v.x, mn, rcp4096, near), t1 = t_fast(v.y, mn, rcp4096, near);
      float t2 = t_fast(v.z, mn, rcp4096, near), t3 = t_fast(v.w, mn, rcp4096, near);
      if (near) {  // rare: the IEEE quotient decides all four
        t0 = t_exact(v.x, mn, span);
        t1 = t_exact(v.y, mn, span);
        t2 = t_exact(v.z, mn, span);
        t3 = t_exact(v.w, mn, span);
      }
      atomicAdd(&hist[floor_bin(t0)], 1);
      atomicAdd(&hist[floor_bin(t1)], 1);
      atomicAdd(&hist[floor_bin(t2)], 1);
      atomicAdd(&hist[floor_bin(t3)], 1);
    }
    __syncthreads();
    // the cluster's next row: its slice lands while this row is merged and
    // read out
    const Slice next = g + n_clusters < G ? slice_of(x, g + n_clusters, P, S, r) : sl;
    if (fits && tid == 0 && g + n_clusters < G) load_slice(next, buf, bars);
    {  // warp w sums this block's counts in block w's range of bins
      const int4* h4 = reinterpret_cast<const int4*>(hist + warp * kOwn + lane * 16);
      int s = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int4 v = h4[k];
        s += v.x + v.y + v.z + v.w;
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) range_sum[warp] = s;
    }
    cluster.sync();  // 2: every histogram and its range sums complete

    // 3. reduce-scatter: this block's bins summed over the cluster in rank order
    int2 own = make_int2(0, 0);
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      const int2 v =
          *reinterpret_cast<const int2*>(cluster.map_shared_rank(hist, q) + r * kOwn + 2 * tid);
      own.x += v.x;
      own.y += v.y;
    }
    if (warp == 0) {  // the count below bin 512 r: lane q adds block q's ranges before r
      int p = 0;
      if (lane < kCluster) {
        const int4* rs = reinterpret_cast<const int4*>(cluster.map_shared_rank(&range_sum[0], lane));
        const int4 a = rs[0], b = rs[1];
        p = (r > 0 ? a.x : 0) + (r > 1 ? a.y : 0) + (r > 2 ? a.z : 0) + (r > 3 ? a.w : 0) +
            (r > 4 ? b.x : 0) + (r > 5 ? b.y : 0) + (r > 6 ? b.z : 0);
      }
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) prefix_s = p;
    }
    // 3: this block reads no other's shared memory after this arrival; the
    // wait at the end of the row keeps its own histogram and range sums
    // until every block has arrived (the scan and readout run meanwhile)
    __cluster_barrier_arrive();

    // the inclusive scan of the 512 owned bins, two a thread
    const int pair = own.x + own.y;
    int incl = pair;
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
    const int prefix = prefix_s;
    const int base = prefix + incl - pair + (warp > 0 ? scan[warp - 1] : 0);
    cdf[2 * tid] = base + own.x;
    cdf[2 * tid + 1] = base + pair;
    const float below = static_cast<float>(prefix);
    const float upto = static_cast<float>(prefix + scan[kWarps - 1]);
    __syncthreads();

    // 4. readout of the percents whose bin this block owns, one warp a percent
    const float pm1 = static_cast<float>(P - 1);
    for (int l = warp; l < L; l += kWarps) {
      const float tgt = __fadd_rn(__fmul_rn(pct[l], pm1), 1.0f);
      const bool owned =
          (r == 0 || below < tgt) && (r == kCluster - 1 || !(upto < tgt));
      if (!owned) continue;  // the same for the whole warp
      int cnt = 0;
      for (int b = lane; b < kOwn; b += 32) cnt += static_cast<float>(cdf[b]) < tgt;
      for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (lane == 0) {
        const int i = min(cnt, kOwn - 1);  // clips only the last block's count 4096
        const float c_hi = static_cast<float>(cdf[i]);
        const float c_lo = i > 0 ? static_cast<float>(cdf[i - 1]) : below;
        float frac = __fdiv_rn(__fsub_rn(tgt, c_lo), fmaxf(__fsub_rn(c_hi, c_lo), 1.0f));
        frac = fminf(fmaxf(frac, 0.0f), 1.0f);
        const float pos = __fdiv_rn(__fadd_rn(static_cast<float>(r * kOwn + i), frac),
                                    static_cast<float>(kBins));
        out[g * L + l] = __fadd_rn(mn, __fmul_rn(pos, span));
      }
    }
    __cluster_barrier_wait();  // 3
    sl = next;
  }
}

// How many clusters of `cfg`'s shape the current device holds at once, cached
// by device and shared memory (the query costs more than a launch).
cudaError_t resident_clusters(const cudaLaunchConfig_t& cfg, int* n) {
  struct Entry {
    int device, smem, n;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.device == device && e.smem == smem) {
      *n = e.n;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(histogram_percentiles_cluster,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(n, histogram_percentiles_cluster, &cfg);
  if (err != cudaSuccess) return err;
  if (*n < 1) return cudaErrorInvalidConfiguration;
  cache.push_back({device, smem, *n});
  return cudaSuccess;
}

// The launch of G rows of P values: the slice length, whether it fits shared
// memory, and a grid of at most as many clusters as the device holds at once
// (a cluster walks its rows, loading the next row's slices while it finishes
// the current one).  `attr` must outlive `cfg`.
cudaError_t launch_config(long long G, long long P, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr, long long* S, int* fits, int* resident) {
  *S = (P + kCluster - 1) / kCluster;
  *fits = *S <= kSliceFloats;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes =
      static_cast<size_t>(kHistBytes + (*fits ? (*S * 4 + 15) / 16 * 16 : 0));
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  const cudaError_t err = resident_clusters(*cfg, resident);
  if (err != cudaSuccess) return err;
  cfg->gridDim = dim3(static_cast<unsigned>(kCluster * (G < *resident ? G : *resident)));
  return cudaSuccess;
}

}  // namespace

// How many clusters of rows of P values the current device holds at once
// (a negative CUDA error if the query fails).
extern "C" int histogram_percentiles_resident_clusters(long long P) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  long long S;
  int fits, n = 0;
  const cudaError_t err = launch_config(1, P, &cfg, &attr, &S, &fits, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// x: (G, P) fp32 rows, contiguous; pct: (L,) fp32 fractions p/100; out: (G, L)
// fp32.  One launch of clusters of 8 blocks on `stream`; returns the launch's
// CUDA error (0 when it was enqueued).
extern "C" int histogram_percentiles_launch(const void* x, const void* pct, void* out,
                                            long long G, long long P, int L,
                                            void* stream) {
  if (G <= 0 || L <= 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  long long S;
  int fits, resident;
  cudaError_t err = launch_config(G, P, &cfg, &attr, &S, &fits, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, histogram_percentiles_cluster, static_cast<const float*>(x),
                           static_cast<const float*>(pct), static_cast<float*>(out), G, P, L, S,
                           fits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
