// The scalar jax.random draws of the port's serial chains, as device
// functions.  Twin of repro_torch/core/keys.py (and of jax.random under
// jax_threefry_partitionable=True), word for word:
//   split(k, n)[i]      = threefry(k, (0, i))        (both words)
//   fold_in(k, d)       = threefry(k, (0, d))        (both words)
//   random_bits(k)[i]   = b0 ^ b1 of threefry(k, (0, i)), i the flat index
//   uniform(k)[i]       = bitcast((bits >> 9) | 0x3F800000) - 1, max with 0
//   randint(k, lo, hi)[i]: hi_bits, lo_bits from the two keys of split(k),
//     offset = ((hi_bits % span) * m + lo_bits % span) % span in uint32,
//     m = (2^16 % span)^2 % span (JAX's 2^32 mod span multiplier).
#pragma once
#include <cstdint>

#include "threefry.cuh"

namespace jax_random {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ Key fold_in(Key k, uint32_t d) {
  const threefry::Pair p = threefry::hash(k.k0, k.k1, 0u, d);
  return {p.x0, p.x1};
}

// Key i of split(k, n), for any n > i.
__device__ __forceinline__ Key split_at(Key k, uint32_t i) { return fold_in(k, i); }

// Element `index` of random_bits(k, shape) (32-bit words).
__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t index) {
  const threefry::Pair p = threefry::hash(k.k0, k.k1, 0u, index);
  return p.x0 ^ p.x1;
}

// Element `index` of uniform(k, shape) on [0, 1).
__device__ __forceinline__ float uniform(Key k, uint32_t index) {
  const float f = __uint_as_float((random_bits(k, index) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(f, 0.0f);
}

// The two keys of split(k) that randint draws its high and low words from.
struct RandintKeys {
  Key hi, lo;
};

__device__ __forceinline__ RandintKeys randint_keys(Key k) {
  return {split_at(k, 0), split_at(k, 1)};
}

// Element `index` of randint(k, shape, lo, hi), given randint_keys(k); hi > lo.
__device__ __forceinline__ int randint(const RandintKeys& ks, uint32_t index, int lo, int hi) {
  const uint32_t span = static_cast<uint32_t>(hi - lo);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  const uint32_t offset =
      (random_bits(ks.hi, index) % span) * mult + random_bits(ks.lo, index) % span;
  return lo + static_cast<int>(offset % span);
}

// The JAX engine's per-sweep key of replica r: fold_in(fold_in(key, 2t), r).
__device__ __forceinline__ Key replica_key(const int64_t* key_words, const int64_t* t,
                                           uint32_t r) {
  const Key k{static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1])};
  return fold_in(fold_in(k, static_cast<uint32_t>(2 * t[0])), r);
}

}  // namespace jax_random
