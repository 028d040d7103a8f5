// The seed route's keep test (ops/dropout.py), shared by every kernel that
// drops: kernel 1's epilogue and keep-mask kernel (se_epilogue.cu) and the
// flash forward's dropout instances (flash_attention.cu).
//
// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R with R = 10)
// under the key (seed lo, seed hi) and the counter (e/4 lo, e/4 hi, pass, 0):
// element e of a pass keeps when word e mod 4 satisfies
// (bits >> 8) * 2^-24 < 1 - p, exact in fp32; the same test in integers is
// bits <= keep_threshold (below), which the flash forward's head-shared
// dropout instance uses.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace philox {

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

// The ten round keys of a key: round r adds r Weyl steps.  A loop that makes
// many calls under one key computes them once (RoundKeys) instead of in
// every call.
struct RoundKeys {
  uint2 k[10];
};

__device__ __forceinline__ RoundKeys round_keys(uint2 k) {
  RoundKeys rk;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    rk.k[r] = k;
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return rk;
}

// N calls in lockstep, round by round: N independent chains of multiplies
// for the scheduler to interleave (one call is a chain of 10 dependent
// rounds, each a wide multiply and its xors).
template <int N>
__device__ __forceinline__ void philox4x32_10(uint4 (&c)[N], const RoundKeys& rk) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned lo0 = 0xD2511F53u * c[i].x, hi0 = __umulhi(0xD2511F53u, c[i].x);
      const unsigned lo1 = 0xCD9E8D57u * c[i].z, hi1 = __umulhi(0xCD9E8D57u, c[i].z);
      c[i] = make_uint4(hi1 ^ c[i].y ^ rk.k[r].x, lo1, hi0 ^ c[i].w ^ rk.k[r].y, lo0);
    }
  }
}

__device__ __forceinline__ uint2 seed_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}

__device__ __forceinline__ unsigned keep_bit(unsigned bits, float keep_prob) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f < keep_prob;  // 2^-24
}

// The keep test in integers: (bits >> 8) * 2^-24 < keep_prob exactly when
// bits <= threshold = ceil(keep_prob 2^24) 2^8 - 1 (the left side is an
// integer times 2^-24; keep_prob in (0, 1], so the threshold fits 32 bits),
// computed once a launch on the host.
__host__ __device__ inline unsigned keep_threshold(float keep_prob) {
  const double c = static_cast<double>(keep_prob) * 16777216.0;  // exact
  double ceil_c = static_cast<double>(static_cast<unsigned long long>(c));
  if (ceil_c < c) ceil_c += 1.0;
  return static_cast<unsigned>(ceil_c * 256.0 - 1.0);
}

// The four words of elements 4q .. 4q+3 of pass `pass`: Philox of the
// counter (q lo, q hi, pass, 0).
__device__ __forceinline__ uint4 words4(uint2 key, unsigned long long q, unsigned pass) {
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(q), static_cast<unsigned>(q >> 32), pass, 0u), key);
}

// The keep test of elements 4q .. 4q+3 of pass `pass`: bit k of the result
// keeps element 4q+k.
__device__ __forceinline__ unsigned keep4(uint2 key, unsigned long long q, unsigned pass,
                                          float keep_prob) {
  const uint4 r = words4(key, q, pass);
  return keep_bit(r.x, keep_prob) | keep_bit(r.y, keep_prob) << 1 |
         keep_bit(r.z, keep_prob) << 2 | keep_bit(r.w, keep_prob) << 3;
}

// The keep test of element e of pass `pass` alone: keep4's bit e mod 4 for
// q = e / 4, its word selected before the one test (testing all four and
// shifting made the flash forward's dropout instances ~30 % slower).
__device__ __forceinline__ bool keep1(uint2 key, unsigned long long e, unsigned pass,
                                      float keep_prob) {
  const uint4 r = words4(key, e >> 2, pass);
  return keep_bit((e & 2) ? ((e & 1) ? r.w : r.z) : ((e & 1) ? r.y : r.x), keep_prob);
}

}  // namespace philox
