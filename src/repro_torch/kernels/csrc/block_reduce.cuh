// Fixed-order block reductions shared by the sweep kernels: warp shuffles,
// then the warps' partials summed by thread 0 in warp order.  No atomics,
// so a float sum is the same on every run.
#pragma once

namespace block_reduce {

// Sum of `v` over a block of kWarps * 32 threads; the result is meaningful in
// thread 0 only.  `scratch` holds kWarps values in shared memory.  Both
// barriers are part of the contract: callers use them to end a colour.
// `between()` runs in every thread after the first barrier and before the
// second (the fused sweeps refresh a colour's halo there).
template <int kWarps, typename T, typename F>
__device__ __forceinline__ T sum(T v, T* scratch, F&& between) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  between();
  T total = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  __syncthreads();
  return total;
}

template <int kWarps, typename T>
__device__ __forceinline__ T sum(T v, T* scratch) {
  return sum<kWarps>(v, scratch, [] {});
}

}  // namespace block_reduce
