// jax_uniform: the per-sweep uniforms of the engine's default path.
//
// Replaces no Pallas kernel.  The JAX engine's per-sweep path
// (repro/engine/driver.py::_sweep_once with IsingSystem / PottsSystem
// .batched_mcmc_step) draws, for sweep t and replica r,
//   u[r] = jax.random.uniform(fold_in(fold_in(key, 2t), r), shape)
// with XLA outside any kernel; kernels #1 and #4 (sweep.cu) read it back.
// This kernel computes the same numbers, word for word, under
// jax_threefry_partitionable=True:
//   fold_in(k, d)     = threefry(k, (0, d))                (both words)
//   bits[i]           = b0 ^ b1 of threefry(k_r, (0, i))   (i = flat index)
//   uniform           = bitcast((bits >> 9) | 0x3F800000) - 1, max with 0.
// Its plain version is repro_torch/core/keys.py (fold_in + uniform).
//
// Design.  Grid (blocks per replica, R); thread 0 of each block derives the
// key of global slot offset + r (two Threefry blocks) into shared memory
// (a shard of the replica axis draws its slots' streams, offset = its first
// slot; 0 on one device), then every thread
// hashes one block per element it writes, striding over the replica's n
// elements.  t is read through a device pointer, so the engine's sweep
// counter never crosses to the host.
//
// Bound.  One Threefry-20 block (72 32-bit integer instructions) per
// uniform: at L=300, R=1500 (2.7e8 uniforms per Ising sweep) 1.9e10
// instructions, 0.58 ms at Hopper's issue rate of 33.5e12/s (see
// ising_fused.cu), against 1.08 GB of f32 writes (0.32 ms at 3.35 TB/s).
// It is integer-ALU bound; the design hashes nothing beyond one block per
// output and two per block of 256 threads for the key.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, see
// repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // elements per thread per block of the grid

__global__ void __launch_bounds__(kThreads)
jax_uniform_kernel(float* __restrict__ out,
                   const int64_t* __restrict__ key_words,
                   const int64_t* __restrict__ t, long long n,
                   unsigned int offset) {
  __shared__ uint32_t key_r[2];
  const uint32_t rep = blockIdx.y;
  if (threadIdx.x == 0) {
    const uint32_t k0 = static_cast<uint32_t>(key_words[0]);
    const uint32_t k1 = static_cast<uint32_t>(key_words[1]);
    const threefry::Pair kt =
        threefry::hash(k0, k1, 0u, static_cast<uint32_t>(2 * t[0]));
    const threefry::Pair kr = threefry::hash(kt.x0, kt.x1, 0u, rep + offset);
    key_r[0] = kr.x0;
    key_r[1] = kr.x1;
  }
  __syncthreads();
  const uint32_t k0 = key_r[0], k1 = key_r[1];
  float* dst = out + static_cast<size_t>(rep) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const threefry::Pair b = threefry::hash(k0, k1, 0u, static_cast<uint32_t>(i));
    const uint32_t bits = b.x0 ^ b.x1;
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    dst[i] = fmaxf(f, 0.0f);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`: out is (n_replicas, n) f32, row r drawn for global
// slot offset + r; returns cudaGetLastError().
int jax_uniform_launch(void* out, const void* key_words, const void* t,
                       int n_replicas, long long n, unsigned int offset, void* stream) {
  long long blocks = (n + static_cast<long long>(kThreads) * kPerThread - 1) /
                     (static_cast<long long>(kThreads) * kPerThread);
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_replicas));
  jax_uniform_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t), n, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
