// Kernel B: one temp-mode DEO/SEO replica exchange on the O(R) rows.
//
// Replaces (TPU, Pallas): the exchange half of
//   repro/kernels/ising_sweep.py::ising_round_fused_pallas
//     (_ising_round_fused_kernel, its exchange.exchange_step call), i.e.
//   repro/kernels/exchange.py::exchange_step (pair_partners, onehot_gather,
//     rung_energies, decide) with prng.swap_uniforms / prng.seo_coin.
//
// Per launch (one PT round):
//   energy[slot] += ΔE[slot]                     (one f32 add, as the TPU kernel)
//   e_rung[rung[slot]] = energy[slot]            (scatter; the one-hot sum's value)
//   u[r] = swap_uniforms(phase)[r], partner[r] from DEO parity or the SEO coin
//   p[r] = swap_probability(betas[r], betas[partner], e_rung[r], e_rung[partner])
//   decision at the lower rung, perm[r], rung'[slot] = perm[rung[slot]]
//   row k of the (K, R) accept / prob / attempt diagnostics.
// Stages are separated by __syncthreads(); the rows live in shared memory.
//
// Why its own launch.  On the TPU the whole ladder is one grid step.  Here
// kernel A spans R blocks (1,500 at paper size) and the exchange needs every
// block's ΔE, i.e. a grid-wide barrier; two stream-ordered launches are that
// barrier.  One block of 1,024 threads loops over R (R = 1,500 > 1,024).
//
// Bound.  It reads and writes ~30 B per rung (45 KB at R = 1,500) and hashes
// R + 3 Threefry blocks: far below a microsecond of either memory or ALU
// time, so launch latency bounds it.  The design keeps it to one block and
// one launch per round, with no host sync: phase and key words are read
// through device pointers.
//
// Numerics.  p is computed with the expressions of torch's CUDA sigmoid /
// exp (1/(1+expf(-x)), fminf(expf(fminf(x,80)),1)) and built as PyTorch
// builds its own kernels (no fast math, default contraction, so expf is
// the same libdevice code), so p matches the plain version's torch ops on
// the card.  Nothing here is a product followed by a sum that contraction
// could fuse.  JAX on the CPU may differ by an ulp; a decision can then
// flip only when u lies between the two p's.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRowBytes = 5 * 4;  // e_rung, p, rung, accept-at-lower, perm

__device__ __forceinline__ int partner_of(int r, int parity, int n) {
  int p = parity == 0 ? (r ^ 1) : (r == 0 ? 0 : (((r - 1) ^ 1) + 1));
  return p >= n ? r : p;
}

__global__ void __launch_bounds__(kThreads)
exchange_kernel(const int32_t* rung_in, int32_t* rung_out,
                const float* energy_in, float* energy_out,
                const float* __restrict__ de, const float* __restrict__ betas,
                const int64_t* __restrict__ key_words,
                const int64_t* __restrict__ phase0, long long phase_add, int n,
                int seo, int metropolis, bool* __restrict__ acc_row,
                float* __restrict__ prob_row, bool* __restrict__ att_row) {
  extern __shared__ unsigned char smem[];
  float* e_rung = reinterpret_cast<float*>(smem);
  float* prob = e_rung + n;
  int* rung_s = reinterpret_cast<int*>(prob + n);
  int* acc_lo = rung_s + n;
  int* perm = acc_lo + n;

  const uint32_t phase = static_cast<uint32_t>(phase0[0] + phase_add);
  const threefry::Pair ss = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::SWAP_DOMAIN, threefry::SWAP_DOMAIN);
  const threefry::Pair wk = threefry::hash(ss.x0, ss.x1, phase, 0u);
  const int parity =
      seo ? static_cast<int>(threefry::hash(wk.x0, wk.x1, 1u, 0u).x0 & 1u)
          : static_cast<int>(phase & 1u);

  // in-place safe: every slot's rung and energy is read before any write
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = rung_in[i];
    const float e = energy_in[i] + de[i];
    rung_s[i] = r;
    e_rung[r] = e;
    energy_out[i] = e;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int q = partner_of(r, parity, n);
    const float arg = (betas[r] - betas[q]) * (e_rung[r] - e_rung[q]);
    const float p = metropolis ? fminf(expf(fminf(arg, 80.0f)), 1.0f)
                               : 1.0f / (1.0f + expf(-arg));
    const bool is_lower = q != r && r < q;
    const float u = threefry::to_uniform(
        threefry::hash(wk.x0, wk.x1, 0u, static_cast<uint32_t>(r)).x0);
    const bool acc = (u < p) && is_lower;
    acc_lo[r] = acc;
    acc_row[r] = acc;
    prob_row[r] = is_lower ? p : 0.0f;
    att_row[r] = is_lower;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int q = partner_of(r, parity, n);
    const int lower = r < q ? r : q;
    perm[r] = (q != r && acc_lo[lower]) ? q : r;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) rung_out[i] = perm[rung_s[i]];
}

}  // namespace

extern "C" {

long long exchange_smem_bytes(int n) {
  return static_cast<long long>(kRowBytes) * n;
}

// Launches kernel B on `stream`; returns cudaGetLastError() (0 = launched).
int exchange_launch(const void* rung_in, void* rung_out, const void* energy_in,
                    void* energy_out, const void* de, const void* betas,
                    const void* key_words, const void* phase0,
                    long long phase_add, int n, int seo, int metropolis,
                    void* acc_row, void* prob_row, void* att_row, void* stream) {
  const int smem = static_cast<int>(exchange_smem_bytes(n));
  cudaError_t err = cudaFuncSetAttribute(
      exchange_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  exchange_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rung_in), static_cast<int32_t*>(rung_out),
      static_cast<const float*>(energy_in), static_cast<float*>(energy_out),
      static_cast<const float*>(de), static_cast<const float*>(betas),
      static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(phase0), phase_add, n, seo, metropolis,
      static_cast<bool*>(acc_row), static_cast<float*>(prob_row),
      static_cast<bool*>(att_row));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
