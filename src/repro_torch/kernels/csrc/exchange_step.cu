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
// The rows hold the interval's energies already (each shard added its ΔE),
// so nothing is added and the energies are not written back.  Every
// pairing and criterion of the round path: DEO / SEO x logistic /
// metropolis.  Its plain version is repro_torch/kernels/exchange.py::
// exchange_step.
//
// Per chain c (block c): rung'[c], accept / prob / attempt rows[c] at phase
// phase0[c] + phase_add, from key_words[c] (the betas row is shared), and
// the sharded step's own post-work: the rank's slice [start, stop) of
// rung'[c] as a row of its own, and phase'[c] = phase0[c] + phase_add + 1.
// The sharded round step launches nothing else between its gathers and its
// observables.
//
// Design.  This launch holds no lattice, so the block's shared memory is
// free for the rows (the round launches keep theirs for the sweeps and put
// the exchange's rows in a global scratch buffer, exchange.cuh).  512
// threads a block, four lanes of a row a thread at a time, in three stages
// that meet at __syncthreads() over shared memory:
//   (1) the rung, energy and beta rows read once: one 16-byte load a row
//       where a group's four lanes are in range and aligned (chain c's rows
//       start at c*R*4 bytes, so groups are shifted by (c*R) mod 4 to start
//       on the rows' 16-byte words; the ragged head and tail take one load
//       a lane), while the swap stream's keys (ss, wk, SEO's coin: three
//       Threefry blocks in series) are derived; the rung and beta rows are
//       kept, the energies scattered to rung order (e_rung);
//   (2) each pair decided at its lower rung, which writes both entries of
//       perm over e_rung (only that thread reads or writes the pair's
//       entries, all reads first), and the accept / prob / attempt rows, a
//       group's four lanes in one store;
//   (3) rung'[slot] = perm[rung[slot]], the rank's slice and phase'.
// 12 B of shared memory a rung (rung, beta, e_rung / perm): R up to 19,368
// in an H100 block's 232,448 B (opted in above 48 KB, once a device).  Rows
// past that run exchange.cuh's step at kDelta = false (its e_rung and perm
// in a global scratch buffer of kScratchBytes a rung), then the same
// post-work; the wrapper chooses by size, and a refused launch raises.
//
// Bits.  rung', accept, prob and attempt are those of exchange.cuh's step (a
// round launch's exchange; the first version of this kernel ran the step for
// every R): the same swap_keys, swap_uniform and swap_probability, built with
// -fmad=false.  The step computes p and u at every rung; its outputs use
// them only at lower rungs, where alone this kernel computes them.
//
// Bound.  22 B a rung (rung, energy and beta read, 12 B; rung, accept, prob
// and attempt written, 10 B) and 4 B a slot of the slice: 39 KB at R = 1,500
// with the whole row as the slice (0.0116 us at 3.35 TB/s); R/2 + 3 Threefry
// blocks at the issue rate (0.0016 us); and one dependent chain, three
// Threefry blocks (ss, wk, u) and an expf, ~0.27 us at 4 cycles an
// instruction and 1.98 GHz.  All far below a launch: what it costs is the
// launch and one block's three stages, latency.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, as the
// round kernels, see repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "exchange.cuh"

namespace {

constexpr int kThreads = 512;  // the round kernels' last block (kernel A) is 512 wide
constexpr int kLanes = 4;      // lanes of a row a thread takes at once
constexpr long long kSharedBytesPerRung = 3 * 4;  // rung, beta, e_rung / perm
constexpr int kMaxShared = 232448;                // an H100 block's shared memory

// The standalone launch's own outputs beside the Round's rows.
struct Post {
  int32_t* block_out;  // (C, stop - start): rung'[c, start:stop]
  int start, stop;
  int64_t* phase_out;  // (C,): phase0[c] + phase_add + 1
};

// Four lanes of a T row as one access: 16 B of a 4-byte row, 4 B of a bool row.
template <typename T>
using Word = typename std::conditional<sizeof(T) == 4, uint4, uint32_t>::type;

// Whether lanes [first, first + kLanes) of a row of n are all in range and
// one aligned Word.
template <typename T>
__device__ __forceinline__ bool one_word(const T* row, int first, int n) {
  return first >= 0 && first + kLanes <= n &&
         reinterpret_cast<uintptr_t>(row + first) % sizeof(Word<T>) == 0;
}

template <typename T>
__device__ __forceinline__ void load_lanes(const T* row, int first, int n, T (&v)[kLanes]) {
  if (one_word(row, first, n)) {
    const Word<T> w = *reinterpret_cast<const Word<T>*>(row + first);
    memcpy(v, &w, sizeof(w));
    return;
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (first + k >= 0 && first + k < n) v[k] = row[first + k];
  }
}

template <typename T>
__device__ __forceinline__ void store_lanes(T* row, int first, int n, const T (&v)[kLanes]) {
  if (one_word(row, first, n)) {
    Word<T> w;
    memcpy(&w, v, sizeof(w));
    *reinterpret_cast<Word<T>*>(row + first) = w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    if (first + k >= 0 && first + k < n) row[first + k] = v[k];
  }
}

__device__ __forceinline__ void write_phase(const exchange::Round& rd, const Post& post, int c) {
  if (threadIdx.x == 0) post.phase_out[c] = rd.phase0[0] + rd.phase_add + 1;
}

__global__ void __launch_bounds__(kThreads)
exchange_shared_kernel(const exchange::Round round, const int64_t* __restrict__ key_words,
                       const Post post) {
  extern __shared__ int4 smem[];
  const int c = blockIdx.x, tid = threadIdx.x;
  const exchange::Round rd = round.at(c);
  const int n = rd.n, padded = (n + kLanes - 1) / kLanes * kLanes;
  int* rung_s = reinterpret_cast<int*>(smem);
  float* beta_s = reinterpret_cast<float*>(rung_s + padded);
  float* e_rung = beta_s + padded;
  int* perm = reinterpret_cast<int*>(e_rung);
  // group g holds lanes [kLanes * g - shift, kLanes * g - shift + kLanes)
  const int shift = static_cast<int>(static_cast<long long>(c) * n % kLanes);
  const int groups = (n + shift + kLanes - 1) / kLanes;

  // (1) the rows, with the keys derived while the first group is in flight
  int rg[kLanes] = {};
  float eg[kLanes] = {}, bg[kLanes] = {};
  auto load = [&](int g) {
    const int first = kLanes * g - shift;
    load_lanes(rd.rung_in, first, n, rg);
    load_lanes(rd.energy_in, first, n, eg);
    load_lanes(rd.betas, first, n, bg);
  };
  if (tid < groups) load(tid);
  const exchange::SwapKeys keys = exchange::swap_keys(
      key_words + 2 * c, static_cast<uint32_t>(rd.phase0[0] + rd.phase_add), rd.seo);
  for (int g = tid; g < groups; g += kThreads) {
    if (g != tid) load(g);
    const int first = kLanes * g - shift;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int i = first + k;
      if (i >= 0 && i < n) {
        rung_s[i] = rg[k];
        beta_s[i] = bg[k];
        e_rung[rg[k]] = eg[k];
      }
    }
  }
  __syncthreads();

  // (2) each pair at its lower rung: reads its rows, then writes perm of both
  for (int g = tid; g < groups; g += kThreads) {
    const int first = kLanes * g - shift;
    int q[kLanes];
    float br[kLanes] = {}, bq[kLanes] = {}, er[kLanes] = {}, eq[kLanes] = {};
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int r = first + k;
      q[k] = r >= 0 && r < n ? exchange::partner_of(r, keys.parity, n) : r;
      if (q[k] > r) {
        br[k] = beta_s[r];
        bq[k] = beta_s[q[k]];
        er[k] = e_rung[r];
        eq[k] = e_rung[q[k]];
      }
    }
    bool acc[kLanes] = {}, att[kLanes] = {};
    float prob[kLanes] = {};
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int r = first + k;
      if (q[k] > r) {
        const float p = exchange::swap_probability(br[k], bq[k], er[k], eq[k], rd.metropolis);
        acc[k] = exchange::swap_uniform(keys, r) < p;
        prob[k] = p;
        att[k] = true;
        perm[r] = acc[k] ? q[k] : r;
        perm[q[k]] = acc[k] ? r : q[k];
      } else if (q[k] == r && r >= 0 && r < n) {
        perm[r] = r;
      }
    }
    store_lanes(rd.acc_row, first, n, acc);
    store_lanes(rd.prob_row, first, n, prob);
    store_lanes(rd.att_row, first, n, att);
  }
  __syncthreads();

  // (3) rung'[slot] = perm[rung[slot]], the rank's slice of it, phase'
  int32_t* block = post.block_out + static_cast<size_t>(c) * (post.stop - post.start);
  for (int g = tid; g < groups; g += kThreads) {
    const int first = kLanes * g - shift;
    int out[kLanes] = {};
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int i = first + k;
      if (i >= 0 && i < n) out[k] = perm[rung_s[i]];
    }
    store_lanes(rd.rung_out, first, n, out);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int i = first + k;
      if (i >= post.start && i < post.stop && i < n) block[i - post.start] = out[k];
    }
  }
  write_phase(rd, post, c);
}

// Rows past shared memory: exchange.cuh's step over a global scratch
// buffer, then the slice read back from rung' and phase'.
__global__ void __launch_bounds__(kThreads)
exchange_global_kernel(const exchange::Round round, const int64_t* __restrict__ key_words,
                       const Post post) {
  const int c = blockIdx.x;
  const exchange::Round rd = round.at(c);
  exchange::step<false>(rd, nullptr, key_words + 2 * c);
  __syncthreads();  // every thread's rung' stores before the slice reads them
  int32_t* block = post.block_out + static_cast<size_t>(c) * (post.stop - post.start);
  for (int i = post.start + threadIdx.x; i < post.stop; i += kThreads) {
    block[i - post.start] = rd.rung_out[i];
  }
  write_phase(rd, post, c);
}

}  // namespace

extern "C" {

// Exchange scratch bytes a replica of the global variant (exchange.cuh).
long long exchange_scratch_bytes() { return exchange::kScratchBytes; }

// Dynamic shared memory of the shared variant over rows of n rungs; the
// wrapper takes the global variant where it exceeds a block's.
long long exchange_step_smem_bytes(int n) {
  return kSharedBytesPerRung * ((n + kLanes - 1) / kLanes * kLanes);
}

// Launches on `stream` of `device` over n_chains chains of n rungs:
// rung_in / rung_out (C, n) int32, energy (C, n) f32, betas (n,) f32,
// phase0 / phase_out (C,) int64, key_words (C, 2) int64, the accept / prob /
// attempt rows (C, n), block_out (C, block_stop - block_start) int32.  A
// null scratch runs the shared variant; else scratch holds kScratchBytes *
// C * n bytes for the global one.  Returns cudaGetLastError().
int exchange_step_launch(const void* rung_in, void* rung_out, const void* energy,
                         const void* betas, const void* phase0, void* phase_out,
                         const void* key_words, int n, int n_chains, int seo, int metropolis,
                         void* acc_row, void* prob_row, void* att_row, void* block_out,
                         int block_start, int block_stop, void* scratch, int device,
                         void* stream) {
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const exchange::Round round = exchange::make_round(
      rung_in, rung_out, energy, nullptr, betas, phase0, 0, n, seo, metropolis, acc_row,
      prob_row, att_row, scratch, nullptr);
  const Post post = {static_cast<int32_t*>(block_out), block_start, block_stop,
                     static_cast<int64_t*>(phase_out)};
  const auto* keys = static_cast<const int64_t*>(key_words);
  const auto s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    // devices on which the kernel may take more than 48 KB (set once each)
    static unsigned long long opted_in = 0;
    const unsigned long long bit = 1ull << (device & 63);
    if (!(opted_in & bit) &&
        cudaFuncSetAttribute(exchange_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared) == cudaSuccess) {
      opted_in |= bit;
    }
    exchange_shared_kernel<<<n_chains, kThreads, exchange_step_smem_bytes(n), s>>>(
        round, keys, post);
  } else {
    exchange_global_kernel<<<n_chains, kThreads, 0, s>>>(round, keys, post);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
