// Kernel #2p: kernel A's S checkerboard Ising sweeps per launch, with the
// spins of up to 8 replicas packed into the bits of one byte (multispin
// coding), on kernel A's scaffold (checkerboard.cuh).
//
// Replaces (TPU, Pallas):
//   repro/kernels/ising_sweep.py::_ising_sweep_body_packed (with _pack_spins,
//     _unpack_spins, _majority, _sel_cnt, _ising_de_tables), the pack_bits
//     body of ising_sweep_fused_pallas and of ising_round_fused_pallas.
//
// Interface.  Kernel A's, argument for argument, and a group width: int8
// (R, L, L) spins in and out (they may alias), ΔE f32 (R,), nacc i32 (R,),
// the rung map, the per-rung p rows and the 10-entry ΔE row the wrapper
// builds with the plain version's ops, the run-key words and the device
// sweep counter, and the round's exchange arguments (exchange.cuh).  A
// slot's beta is betas[rung[slot]], read in-kernel, so one kernel serves the
// interval-fused path (identity rung, no exchange) and the whole-round path,
// one launch a round: the last block to finish runs the exchange over all R
// slots once (never a group's padding bits: the grid's last group is
// partial, not padded).  The engine's state stays int8: a block packs on
// load and unpacks on store, as the JAX kernel does.
//
// Word width.  The JAX kernel packs 32 replicas into a uint32 plane.  On an
// SM a 32-replica plane at the paper's L = 300 takes 4 L^2 = 360 KB of
// shared memory, over the 227 KB a block may hold.  A byte holds up to 8
// replicas in kernel A's own haloed tile, so this kernel runs every L and R
// that kernel A runs.  One block owns one group of `group` <= 8 consecutive
// replicas (slots g*group ..); the last group may be partial (R = 1500 at
// width 6 is 250 full groups, the conformance entry has R = 5): the width is
// a template argument, so unused bits are never counted, drawn for or
// written back.  A group of one is kernel A's update itself.
//
// Group width.  Two ~94 KB blocks fit an SM.  The wrapper picks the widest
// group that minimises the busiest SM's replica count (6 at R = 1500: 250
// blocks, 12 replicas on the busiest SM, as for kernel A), and a caller may
// fix it.  No result depends on the grouping.
//
// Design.  The shared scaffold at kRep = group (checkerboard.cuh): colour-
// paired haloed lattice, 512 threads, runs of 8 sites of one row, one
// carried step a run; each replica's sweep key schedule made once per sweep
// into shared memory; kRep fixed-order block reductions per colour.  The
// site update (ising_rules.cuh, PackedRule) forms the up-neighbour count's
// bit-planes n0, n1, n2 once per site with the bitwise full adder of the
// JAX kernel, then, replica by replica with one schedule and eight hash
// chains live, picks the threshold entry from bit r of the spin and plane
// bytes (one multiply), hashes, compares and flips bit r; it writes the
// byte once.  A padding site's word selects an entry that never accepts, so
// the replica pass has no branch.  Per update the pass is ~76 SASS
// instructions (the cipher's ~64, the entry, the compare, the counters) and
// the site's loads, adder and store add ~26 a site, shared by the group:
// ~81 at width 6 against kernel A's ~90 (fused_probe.py).
//
// What holds it back: the pass keeps ~48 registers live (eight words, the
// replicas' partial sums and counts, the schedule), so at 64 a thread the
// compiler runs the eight hash chains one after another where kernel A
// interleaves three to five, and #2p issues fewer instructions per clock:
// 1.04x kernel A's time at R=1500 on an H100 80GB HBM3 at 700 W (PERF.md §6).
//
// Stream and sums.  Replica r of the group draws kernel A's uniform,
// to_uniform(hash(sweep_key(t0 + sweep, first + r + replica_offset), colour,
// site).x0), where `first` is the group's first slot, so spins and nacc
// equal kernel A's bit for bit for any j and b.  A thread walks kernel A's
// runs in kernel A's order and adds replica r's accepted ΔE terms to its
// partial in that order, and the per-colour reductions are kernel A's, so
// ΔE equals kernel A's bit for bit too.
//
// First version: kernel A's first site loop per byte (lattice::colour_site,
// 256 threads by flat colour index, one load chain per site): 61.4 ms at
// L=300 R=1500 S=100, 1.24x kernel A after kernel A's redesign, on an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 10; PERF.md §6).
//
// Bound.  Kernel A's: the Threefry work, one block per site update (72
// 32-bit instructions each), is 29.055 ms at L=300, R=1500, S=100 on the
// instruction-issue rate; the lattice moves once each way (2 B/cell).
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
constexpr int kGroup = 8;  // replicas a byte can hold
// shared-memory header: float/int reduction scratch, the group's
// threshold/ΔE rows and the scaffold's per-replica scratch (16-byte aligned)
constexpr int kRow = ising::PackedRule<kGroup>::kRow;
constexpr int kTableOffset = kWarps * 8;
constexpr int kScratchOffset = kTableOffset + kGroup * kRow * 8;
constexpr int kHeaderBytes =
    kScratchOffset + static_cast<int>(sizeof(checkerboard::Scratch<kGroup>));
static_assert(kScratchOffset % 16 == 0 && kHeaderBytes % 16 == 0, "scratch alignment");

// S sweeps of one group of K replicas starting at slot `first`.
template <int K>
__device__ __forceinline__ void group_sweeps(
    unsigned char* smem, const int8_t* spins_in, int8_t* spins_out,
    float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
    const int32_t* rung, const float* __restrict__ p_tab,
    const float* __restrict__ de_tab, const int64_t* __restrict__ key_words,
    const int64_t* __restrict__ t0, long long t_add, unsigned int replica_offset,
    int first, int L, int n_sweeps, const exchange::Round& round) {
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  checkerboard::Entry* tab = reinterpret_cast<checkerboard::Entry*>(smem + kTableOffset);
  auto* scratch = reinterpret_cast<checkerboard::Scratch<K>*>(smem + kScratchOffset);
  uint8_t* lat = smem + kHeaderBytes;

  // K rows of kRow entries: the rung's 10, then entries that never accept
  for (int i = threadIdx.x; i < K * kRow; i += kThreads) {
    const int r = i / kRow, e = i % kRow;
    tab[i] = e < 10 ? checkerboard::Entry{checkerboard::threshold(p_tab[rung[first + r] * 10 + e]),
                                          de_tab[e]}
                    : checkerboard::Entry{0u, 0.0f};
  }
  const size_t cells = static_cast<size_t>(L) * L;
  const uint32_t rep = static_cast<uint32_t>(first) + replica_offset;
  if constexpr (K == 1) {
    checkerboard::sweeps<kThreads, kSites, 1>(
        ising::Rule{tab}, lat, fred, ired, nullptr, spins_in + first * cells,
        spins_out + first * cells, de_out, nacc_out, first, key_words, t0, t_add, rep,
        L, L, n_sweeps, round);
  } else {
    checkerboard::sweeps<kThreads, kSites, K>(
        ising::PackedRule<K>{tab}, lat, fred, ired, scratch, spins_in + first * cells,
        spins_out + first * cells, de_out, nacc_out, first, key_words, t0, t_add, rep,
        L, L, n_sweeps, round);
  }
}

// spins_in may alias spins_out: a block reads its group's lattices into
// shared memory before it writes anything back, and touches no other group.
// `rung` may be round.rung_out (see ising_fused.cu).  The grid is (groups,
// C chains), the per-chain arrays laid out as in ising_fused.cu.
__global__ void __launch_bounds__(kThreads, 2)
ising_packed_kernel(const int8_t* spins_in, int8_t* spins_out,
                    float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                    const int32_t* rung,
                    const float* __restrict__ p_tab,
                    const float* __restrict__ de_tab,
                    const int64_t* __restrict__ key_words,
                    const int64_t* __restrict__ t0, long long t_add,
                    unsigned int replica_offset, int n_replicas, int group,
                    int L, int n_sweeps, const exchange::Round round) {
  extern __shared__ __align__(16) unsigned char smem[];
  // chain blockIdx.y: its slots, rows, key words and counter at a fixed
  // offset from chain 0's; a group never straddles two chains
  const int chain = blockIdx.y;
  const size_t base = static_cast<size_t>(chain) * n_replicas;
  spins_in += base * L * L;
  spins_out += base * L * L;
  rung += base;
  de_out += base;
  nacc_out += base;
  key_words += 2 * chain;
  t0 += chain;
  const exchange::Round rd = round.chain(chain);
  const int first = blockIdx.x * group;
  const int bits = n_replicas - first < group ? n_replicas - first : group;
#define REPRO_GROUP(K)                                                           \
  case K:                                                                        \
    group_sweeps<K>(smem, spins_in, spins_out, de_out, nacc_out, rung, p_tab,    \
                    de_tab, key_words, t0, t_add, replica_offset, first, L,      \
                    n_sweeps, rd);                                               \
    break;
  switch (bits) {  // uniform over the block: only the last group is partial
    REPRO_GROUP(1)
    REPRO_GROUP(2)
    REPRO_GROUP(3)
    REPRO_GROUP(4)
    REPRO_GROUP(5)
    REPRO_GROUP(6)
    REPRO_GROUP(7)
    REPRO_GROUP(8)
    default:
      break;
  }
#undef REPRO_GROUP
  if (rd.ticket != nullptr) {  // one copy of the exchange for all group widths
    const int* flag = reinterpret_cast<int*>(smem + kWarps * 4);  // group_sweeps' ired
    exchange::exchange_if_last(rd, de_out, key_words, flag);
  }
}

}  // namespace

extern "C" {

// Exchange scratch bytes a replica (exchange.cuh): the wrapper sizes the
// round launch's scratch buffer from it.
long long exchange_scratch_bytes() { return exchange::kScratchBytes; }

// The launch takes a chain count (the grid's second dimension).
int chain_axis() { return 1; }

// Shared-memory bytes one launch needs at lattice side L.
long long ising_packed_smem_bytes(int length) {
  return kHeaderBytes + checkerboard::lattice_bytes<kSites>(length, length);
}

// Threads per block of every launch.
int ising_packed_threads() { return kThreads; }

// Blocks of a launch at lattice side L that one SM holds at once, into
// *blocks; returns a cudaError_t (0 = answered).
int ising_packed_blocks_per_sm(int length, int* blocks) {
  const int smem = static_cast<int>(ising_packed_smem_bytes(length));
  cudaError_t err = cudaFuncSetAttribute(
      ising_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ising_packed_kernel, kThreads, smem));
}

// Launches kernel #2p on `stream`, one block per `group` (1..8) replicas of
// each of n_chains chains; returns cudaGetLastError() (0 = launched).  The
// arguments from rung_out on are the round's exchange, as for kernel A.
int ising_packed_launch(const void* spins_in, void* spins_out, void* de_out,
                        void* nacc_out, const void* rung, const void* p_tab,
                        const void* de_tab, const void* key_words, const void* t0,
                        long long t_add, unsigned int replica_offset,
                        int n_replicas, int n_chains, int length, int n_sweeps, int group,
                        void* rung_out, const void* energy_in, void* energy_out,
                        const void* betas, const void* phase0, long long phase_add,
                        int seo, int metropolis, void* acc_row, void* prob_row,
                        void* att_row, void* scratch, void* ticket, void* stream) {
  if (group < 1 || group > kGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(ising_packed_smem_bytes(length));
  cudaError_t err = cudaFuncSetAttribute(
      ising_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ising_packed_kernel<<<dim3((n_replicas + group - 1) / group, n_chains), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, n_replicas, group,
      length, n_sweeps,
      exchange::make_round(rung, rung_out, energy_in, energy_out, betas, phase0, phase_add,
                           n_replicas, seo, metropolis, acc_row, prob_row, att_row,
                           scratch, ticket));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
