// exchange_step: the temp-mode DEO/SEO exchange alone, one launch over the
// gathered (C, R) rows of C chains, one block a chain.
//
// Replaces (TPU, Pallas / XLA): repro/kernels/exchange.py::exchange_step as
// the JAX engine's sharded round path runs it on its own
// (repro/engine/driver.py::make_sharded_interval_step, the fused_round
// branch): with the replica axis split over devices no launch holds a whole
// round, so each device runs its shard's interval-fused sweeps (kernel A,
// #2p or #5 with a replica offset), all-gathers the (R,) energy and rung
// rows, and reruns the full-ladder exchange from the round kernel's own
// counter swap stream on the gathered rows, redundantly on every device.
// The exchange is exchange.cuh's step, the code the round launches run in
// their last block, at kDelta = false: the rows hold the interval's
// energies already (each shard added its ΔE), so nothing is added and the
// energies are not written back.  Every pairing and criterion of the round
// path: DEO / SEO x logistic / metropolis.  Its plain version is
// repro_torch/kernels/exchange.py::exchange_step.
//
// Per chain c (block c): rung'[c], accept / prob / attempt rows[c] at phase
// phase0[c] + phase_add, from key_words[c]; the betas row is shared.
//
// Bound.  22 B a rung (rung, energy and beta read, 12 B; rung, accept,
// prob and attempt written, 10 B; the scratch table is the kernel's own)
// and R + 3 Threefry blocks: at R = 1,500 about 33 KB (0.0099 us at
// 3.35 TB/s) and 1.1e5 integer instructions (0.003 us at 33.5e12/s).  What it costs is the launch and
// one block's three dependent stages over the rows, each at least one round
// trip to L2: latency, as the round launches' tail is (exchange.cuh).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, as the
// round kernels, see repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "exchange.cuh"

namespace {

constexpr int kThreads = 512;  // the round kernels' last block (kernel A) is 512 wide

__global__ void __launch_bounds__(kThreads)
exchange_step_kernel(const exchange::Round round, const int64_t* __restrict__ key_words) {
  const int c = blockIdx.x;
  exchange::step<false>(round.at(c), nullptr, key_words + 2 * c);
}

}  // namespace

extern "C" {

// Exchange scratch bytes a replica (exchange.cuh): the wrapper sizes the
// launch's scratch buffer from it.
long long exchange_scratch_bytes() { return exchange::kScratchBytes; }

// Launches on `stream` over n_chains chains of n rungs: rung_in / rung_out
// (C, n) int32 (may alias), energy (C, n) f32, betas (n,) f32, phase0 (C,)
// int64, key_words (C, 2) int64, the accept / prob / attempt rows (C, n) and
// scratch kScratchBytes * C * n bytes; returns cudaGetLastError().
int exchange_step_launch(const void* rung_in, void* rung_out, const void* energy,
                         const void* betas, const void* phase0, long long phase_add,
                         const void* key_words, int n, int n_chains, int seo,
                         int metropolis, void* acc_row, void* prob_row, void* att_row,
                         void* scratch, void* stream) {
  const exchange::Round round = exchange::make_round(
      rung_in, rung_out, energy, nullptr, betas, phase0, phase_add, n, seo, metropolis,
      acc_row, prob_row, att_row, scratch, nullptr);
  exchange_step_kernel<<<n_chains, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      round, static_cast<const int64_t*>(key_words));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
