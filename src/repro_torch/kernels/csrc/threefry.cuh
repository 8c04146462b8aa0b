// Threefry-2x32-20 and the counter streams of the fused kernels, as device
// functions.  Twin of repro_torch/kernels/prng.py (and of the JAX package's
// repro/kernels/prng.py): same cipher, same counters, same top-24-bit
// uniforms, so a kernel draws word for word what the plain version draws.
#pragma once
#include <cstdint>

namespace threefry {

constexpr uint32_t DOMAIN = 0x46555345u;       // ascii "FUSE", fixed forever
constexpr uint32_t SWAP_DOMAIN = 0x53574150u;  // ascii "SWAP", fixed forever
constexpr uint32_t KS_PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

struct Pair {
  uint32_t x0, x1;
};

// A key's schedule: its three words and the second-word injections
// ks[(g+1)%3] + g, made once per key, so that a loop hashing many counters
// under one key (the fused sweeps' site loops) pays a two-input add per
// injection.
struct Schedule {
  uint32_t ks[3];
  uint32_t inj1[5];
};

__device__ __forceinline__ Schedule schedule(uint32_t k0, uint32_t k1) {
  Schedule s;
  s.ks[0] = k0;
  s.ks[1] = k1;
  s.ks[2] = k0 ^ k1 ^ KS_PARITY;
#pragma unroll
  for (int g = 1; g <= 5; ++g) s.inj1[g - 1] = s.ks[(g + 1) % 3] + static_cast<uint32_t>(g);
  return s;
}

// Threefry-2x32 with 20 rounds under a key schedule, counter (x0, x1).
__device__ __forceinline__ Pair hash(const Schedule& s, uint32_t x0, uint32_t x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += s.ks[0];
  x1 += s.ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[group % 2][r]) ^ x0;
    }
    x0 += s.ks[(group + 1) % 3];
    x1 += s.inj1[group];
  }
  return {x0, x1};
}

// First output words of kN blocks, counters (x0, ctr[n]), under one key
// schedule, round by round across the blocks: the kN chains sit side by
// side in the instruction stream, which is where the compiler keeps them
// when registers are short (kernel #2p's replica pass).
template <int kN>
__device__ __forceinline__ void hash_x0(const Schedule& s, uint32_t x0,
                                        const uint32_t (&ctr)[kN], uint32_t (&out)[kN]) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a[kN], b[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = x0 + s.ks[0];
    b[n] = ctr[n] + s.ks[1];
  }
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        a[n] += b[n];
        b[n] = rotl(b[n], rot[group % 2][r]) ^ a[n];
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      a[n] += s.ks[(group + 1) % 3];
      b[n] += s.inj1[group];
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) out[n] = a[n];
}

// Threefry-2x32 with 20 rounds: key (k0, k1), counter (x0, x1).
__device__ __forceinline__ Pair hash(uint32_t k0, uint32_t k1, uint32_t x0,
                                     uint32_t x1) {
  return hash(schedule(k0, k1), x0, x1);
}

// Top 24 bits as an f32 in [0, 1): exact, never 1.0.
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

}  // namespace threefry
