// Kernel #5: S checkerboard q-state Potts sweeps per launch, lattice
// resident in shared memory, Threefry uniforms drawn in-kernel.
//
// Replaces (TPU, Pallas):
//   repro/kernels/potts_sweep.py::potts_sweep_fused_pallas
//     (_potts_sweep_fused_kernel, _potts_sweep_body), and
//   repro/kernels/potts_sweep.py::potts_round_fused_pallas
//     (_potts_round_fused_kernel: its sweeps here, its exchange in the same
//     launch by the last block to finish, exchange.cuh).
// Both pack_bits settings of the JAX kernel run here: the lattice is int8
// throughout, which is what pack_bits=True asks for (q <= 64), and the JAX
// package pins the two trajectories as bitwise equal.
//
// Design: kernel A's, one scaffold (checkerboard.cuh): one block per replica
// slot, colour-paired haloed lattice in shared memory, runs of kSites sites
// of one row per thread, each site hashing two independent Threefry blocks
// of the sweep key at counter i*W + j, plane 2*colour (proposal) and plane
// 2*colour+1 (acceptance).  The slot's beta is betas[rung[slot]], so the
// interval path (identity rung, per-slot betas) and the round path
// (rung-ordered betas, and the exchange's arguments: one launch a round)
// share this kernel.
//
// The update.  The proposal is the plain version's, d = 1 +
// floor(u_prop * (q-1)) in f32, computed as float(bits >> 8) * ((q-1) *
// 2^-24): u_prop is exact, so both products round the same real number
// once.  trial = (s + d) % q is min(s + d, s + d - q) in unsigned
// arithmetic, exactly, as 0 <= s < q and 1 <= d <= q.  The (up, down, left,
// right) tuple of terms 1 + [s == nbr] - [trial == nbr] indexes ΔE and the
// acceptance threshold in the 81-entry rows the wrapper built with the plain
// version's ops (see sweep.cu); the four neighbours' colours sit in the
// bytes of one word, so both sets of equalities and the weighted index come
// from a few word operations instead of eight compares and selects.  Colours
// and counts equal the plain version's for any j and rule; ΔE is exact at
// j=1 and otherwise differs only in the order inside one colour's sum.
//
// Bound.  At H=W=300, R=1500, S=100: 2 Threefry-20 blocks of 72 32-bit
// instructions per site update, 2.7e10 blocks, 1.9e12 instructions, 58.110
// ms at the 33.5e12/s issue rate (see ising_fused.cu), against 270 MB of
// lattice traffic (0.08 ms at 3.35 TB/s).  Integer-instruction bound.
//
// First version: kernel A's first design plus lattice::potts_trial
// (a runtime `% q`, eight compare/select pairs), 253 SASS instructions per
// update: 146.4 ms at S=100, 2.52x the bound, on an H100 80GB HBM3 at 700 W
// (fused_probe.py; PERF.md §6).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "checkerboard.cuh"
#include "lattice.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSites = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kHeaderBytes = kWarps * 8 + lattice::kPottsTable * 8;

// 1 in each byte of nb that equals x, else 0 (every byte and x below 128,
// so adding 0x7F to a byte never carries into the next).
__device__ __forceinline__ uint32_t equal_bytes(uint32_t nb, uint32_t x) {
  const uint32_t y = nb ^ (x * 0x01010101u);
  return (~(y + 0x7F7F7F7Fu) >> 7) & 0x01010101u;
}

// weights of the up, down, left and right terms of the 81-entry index, one
// per byte, reversed so that they meet their terms in the product's top byte
constexpr uint32_t kWeights = (27u << 24) | (9u << 16) | (3u << 8) | 1u;

struct PottsRule {
  const checkerboard::Entry* tab;
  int q;
  float scale;  // (q - 1) * 2^-24

  __device__ static uint8_t to_shared(int8_t s) { return static_cast<uint8_t>(s); }
  __device__ static int8_t from_shared(uint8_t v) { return static_cast<int8_t>(v); }

  template <int kN>
  __device__ __forceinline__ void update(const checkerboard::Site (&st)[kN],
                                         const threefry::Schedule& ks, int c,
                                         float& part, int& nacc) const {
    int trial[kN], e[kN];
    uint32_t acc[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const uint32_t prop = threefry::hash(ks, static_cast<uint32_t>(2 * c), st[s].ctr).x0;
      acc[s] = threefry::hash(ks, static_cast<uint32_t>(2 * c + 1), st[s].ctr).x0;
      const uint32_t v = st[s].v;
      // (s + d) % q as min(s + d, s + d - q) in unsigned: s + d < 2q
      const uint32_t sd = v + 1u + static_cast<uint32_t>(
          floorf(static_cast<float>(prop >> 8) * scale));
      const uint32_t t = min(sd, sd - static_cast<uint32_t>(q));
      trial[s] = static_cast<int>(t);
      // the neighbours' colours, one byte each (all < 128): up, dn, lf, rt
      const uint32_t nb = st[s].up | st[s].dn << 8 | st[s].lf << 16 | st[s].rt << 24;
      // byte d of `terms` is 1 + [v == n_d] - [t == n_d]; the product's top
      // byte is their sum weighted 27, 9, 3, 1 (no byte carries: <= 80)
      const uint32_t terms = equal_bytes(nb, v) - equal_bytes(nb, t) + 0x01010101u;
      e[s] = static_cast<int>((terms * kWeights) >> 24);
    }
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const checkerboard::Entry ent = tab[e[s]];
      if (st[s].live && checkerboard::accept(acc[s], ent.thr)) {
        *st[s].at = static_cast<uint8_t>(trial[s]);
        part += ent.de;
        ++nacc;
      }
    }
  }
};

// states_in may alias states_out: a block reads its whole lattice first.
// `rung` may be round.rung_out (see ising_fused.cu).  The grid is (R slots,
// C chains), the per-chain arrays laid out as in ising_fused.cu.
__global__ void __launch_bounds__(kThreads, 2)
potts_fused_kernel(const int8_t* states_in, int8_t* states_out,
                   float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                   const int32_t* rung, const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab,
                   const int64_t* __restrict__ key_words,
                   const int64_t* __restrict__ t0, long long t_add,
                   unsigned int replica_offset, int H, int W, int q, int n_sweeps,
                   const exchange::Round round) {
  extern __shared__ __align__(8) unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  checkerboard::Entry* tab = reinterpret_cast<checkerboard::Entry*>(smem + kWarps * 8);
  uint8_t* lat = smem + kHeaderBytes;

  // chain blockIdx.y, laid out as in ising_fused.cu
  const int slot = blockIdx.x, chain = blockIdx.y;
  const size_t first = static_cast<size_t>(chain) * gridDim.x;
  rung += first;
  de_out += first;
  nacc_out += first;
  key_words += 2 * chain;
  t0 += chain;
  const float* p_row = p_tab + static_cast<size_t>(rung[slot]) * lattice::kPottsTable;
  for (int i = threadIdx.x; i < lattice::kPottsTable; i += kThreads) {
    tab[i] = {checkerboard::threshold(p_row[i]), de_tab[i]};
  }
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t at = (first + slot) * cells;
  const exchange::Round rd = round.chain(chain);
  const PottsRule rule{tab, q, static_cast<float>(q - 1) * (1.0f / 16777216.0f)};
  checkerboard::sweeps<kThreads, kSites, 1>(
      rule, lat, fred, ired, nullptr, states_in + at, states_out + at, de_out, nacc_out,
      slot, key_words, t0, t_add, static_cast<uint32_t>(slot) + replica_offset, H, W,
      n_sweeps, rd);
  if (rd.ticket != nullptr) exchange::exchange_if_last(rd, de_out, key_words, ired);
}

}  // namespace

extern "C" {

// Exchange scratch bytes a replica (exchange.cuh): the wrapper sizes the
// round launch's scratch buffer from it.
long long exchange_scratch_bytes() { return exchange::kScratchBytes; }

// The launch takes a chain count (the grid's second dimension).
int chain_axis() { return 1; }

long long potts_fused_smem_bytes(int height, int width) {
  return kHeaderBytes + checkerboard::lattice_bytes<kSites>(height, width);
}

// Launches kernel #5 on `stream` over n_chains chains of n_replicas slots;
// returns cudaGetLastError() (0 = launched).  The arguments from rung_out on
// are the round's exchange, as for kernel A.
int potts_fused_launch(const void* states_in, void* states_out, void* de_out,
                       void* nacc_out, const void* rung, const void* p_tab,
                       const void* de_tab, const void* key_words, const void* t0,
                       long long t_add, unsigned int replica_offset, int n_replicas,
                       int n_chains, int height, int width, int q, int n_sweeps,
                       void* rung_out,
                       const void* energy_in, void* energy_out, const void* betas,
                       const void* phase0, long long phase_add, int seo,
                       int metropolis, void* acc_row, void* prob_row, void* att_row,
                       void* scratch, void* ticket, void* stream) {
  const int smem = static_cast<int>(potts_fused_smem_bytes(height, width));
  cudaError_t err = cudaFuncSetAttribute(
      potts_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  potts_fused_kernel<<<dim3(n_replicas, n_chains), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(states_in), static_cast<int8_t*>(states_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, height, width, q,
      n_sweeps,
      exchange::make_round(rung, rung_out, energy_in, energy_out, betas, phase0, phase_add,
                           n_replicas, seo, metropolis, acc_row, prob_row, att_row,
                           scratch, ticket));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
