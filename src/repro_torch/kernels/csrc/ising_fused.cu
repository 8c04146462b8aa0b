// Kernel A: S checkerboard Ising sweeps per launch, lattice resident in
// shared memory, Threefry uniforms drawn in-kernel.
//
// Replaces (TPU, Pallas):
//   repro/kernels/ising_sweep.py::ising_sweep_fused_pallas
//     (_ising_sweep_fused_kernel, _ising_sweep_body), and
//   repro/kernels/ising_sweep.py::ising_round_fused_pallas
//     (_ising_round_fused_kernel: its sweeps here, its exchange in the same
//     launch by the last block to finish, exchange.cuh).
//
// Design: one block per replica slot runs the shared fused sweep loop
// (checkerboard.cuh: colour-paired haloed lattice in shared memory, runs of
// kSites sites of one row per thread, no division or wrap select per site)
// at one replica a block, with the Ising update of ising_rules.cuh.  The
// slot's beta is betas[rung[slot]], read in-kernel from the device rung
// map, so the interval-fused path (identity rung, per-slot betas) and the
// whole-round path (rung-ordered betas) share this kernel; a round launch
// also carries the exchange's arguments, and one launch is one PT round.
// A site's uniform is to_uniform(hash(sweep key, colour, i*L + j).x0), one
// Threefry block per update, the minimum the stream allows.
//
// Acceptance: the wrapper's per-rung rows as thresholds (ising_rules.cuh),
// no expf per site.  Spins and acceptance counts are bit-equal to the plain
// version by construction, for any j, b and rule; ΔE is exact at j=1, b=0
// and otherwise differs from it only in the order inside one colour's sum.
//
// Bound.  At L=300, R=1500, S=100 a launch moves 2 B/cell (270 MB, 0.08 ms
// at 3.35 TB/s) but hashes 1.35e10 Threefry-20 blocks of 72 32-bit
// instructions: 9.7e11 instructions, 29.055 ms at the 33.5e12/s issue rate
// (128 lanes per SM x 132 SMs x 1.98 GHz).  Integer-instruction bound.
//
// First version: 256 threads striding over flat colour indices with
// lattice::colour_site, one dependent hash per thread, 130 SASS
// instructions per site update: 77.5 ms at S=100, 2.67x the bound, on an
// H100 80GB HBM3 at 700 W (fused_probe.py; PERF.md §6 has both counts and
// the new times).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast math), see repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "checkerboard.cuh"
#include "ising_rules.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSites = 8;
constexpr int kWarps = kThreads / 32;
// shared-memory header: float/int reduction scratch + the threshold/ΔE table
constexpr int kHeaderBytes = kWarps * 8 + 10 * 8;

// spins_in may alias spins_out: a block reads its whole lattice into shared
// memory before it writes anything back.  `rung` may be round.rung_out: every
// block reads its rung before the exchange writes the new map.  The grid is
// (R slots, C chains); every per-chain array is (C, ...) with chain c at
// c times chain 0's extent, and p_tab's rows are indexed by the rung values
// as they are (the round path's shared rung-ordered rows, or the fused
// path's per-chain slot rows with rung = c*R + slot).
__global__ void __launch_bounds__(kThreads, 2)
ising_fused_kernel(const int8_t* spins_in, int8_t* spins_out,
                   float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                   const int32_t* rung,
                   const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab,
                   const int64_t* __restrict__ key_words,
                   const int64_t* __restrict__ t0, long long t_add,
                   unsigned int replica_offset, int L, int n_sweeps,
                   const exchange::Round round) {
  extern __shared__ __align__(8) unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  checkerboard::Entry* tab = reinterpret_cast<checkerboard::Entry*>(smem + kWarps * 8);
  uint8_t* lat = smem + kHeaderBytes;

  // chain blockIdx.y of gridDim.y: its rows, key words and counter sit at a
  // fixed offset from chain 0's (the sweep loop below is one chain's)
  const int slot = blockIdx.x, chain = blockIdx.y;
  const size_t first = static_cast<size_t>(chain) * gridDim.x;
  rung += first;
  de_out += first;
  nacc_out += first;
  key_words += 2 * chain;
  t0 += chain;
  if (threadIdx.x < 10) {
    tab[threadIdx.x] = {checkerboard::threshold(p_tab[rung[slot] * 10 + threadIdx.x]),
                        de_tab[threadIdx.x]};
  }
  const size_t cells = static_cast<size_t>(L) * L;
  const size_t at = (first + slot) * cells;
  const exchange::Round rd = round.chain(chain);
  checkerboard::sweeps<kThreads, kSites, 1>(
      ising::Rule{tab}, lat, fred, ired, nullptr, spins_in + at, spins_out + at, de_out,
      nacc_out, slot, key_words, t0, t_add, static_cast<uint32_t>(slot) + replica_offset,
      L, L, n_sweeps, rd);
  if (rd.ticket != nullptr) exchange::exchange_if_last(rd, de_out, key_words, ired);
}

}  // namespace

extern "C" {

// Exchange scratch bytes a replica (exchange.cuh): the wrapper sizes the
// round launch's scratch buffer from it.
long long exchange_scratch_bytes() { return exchange::kScratchBytes; }

// The launch takes a chain count (the grid's second dimension).
int chain_axis() { return 1; }

// Shared-memory bytes one launch needs at lattice side L.
long long ising_fused_smem_bytes(int length) {
  return kHeaderBytes + checkerboard::lattice_bytes<kSites>(length, length);
}

// Launches kernel A on `stream` over n_chains chains of n_replicas slots
// (a grid of n_replicas x n_chains blocks); returns cudaGetLastError()
// (0 = launched).  The arguments from rung_out on are the round's exchange
// (exchange.cuh), with n_chains tickets and n_chains scratch regions; a null
// ticket launches the sweeps alone.
int ising_fused_launch(const void* spins_in, void* spins_out, void* de_out,
                       void* nacc_out, const void* rung, const void* p_tab,
                       const void* de_tab, const void* key_words, const void* t0,
                       long long t_add, unsigned int replica_offset,
                       int n_replicas, int n_chains, int length, int n_sweeps, void* rung_out,
                       const void* energy_in, void* energy_out, const void* betas,
                       const void* phase0, long long phase_add, int seo,
                       int metropolis, void* acc_row, void* prob_row, void* att_row,
                       void* scratch, void* ticket, void* stream) {
  const int smem = static_cast<int>(ising_fused_smem_bytes(length));
  cudaError_t err = cudaFuncSetAttribute(
      ising_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ising_fused_kernel<<<dim3(n_replicas, n_chains), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, length, n_sweeps,
      exchange::make_round(rung, rung_out, energy_in, energy_out, betas, phase0, phase_add,
                           n_replicas, seo, metropolis, acc_row, prob_row, att_row,
                           scratch, ticket));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
