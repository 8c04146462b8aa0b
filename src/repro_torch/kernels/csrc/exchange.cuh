// The temp-mode DEO/SEO replica exchange of one PT round, run inside the
// sweep launch of kernel A (ising_fused.cu), #2p (ising_packed.cu) or #5
// (potts_fused.cu) by the block that finishes its sweeps last: one launch
// is one PT round, as one pallas_call is on the TPU.
//
// Replaces (TPU, Pallas): the exchange half of
//   repro/kernels/ising_sweep.py::ising_round_fused_pallas
//     (_ising_round_fused_kernel, its exchange.exchange_step call) and of
//   repro/kernels/potts_sweep.py::potts_round_fused_pallas, i.e.
//   repro/kernels/exchange.py::exchange_step (pair_partners, onehot_gather,
//     rung_energies, decide) with prng.swap_uniforms / prng.seo_coin.
//
// Per round:
//   energy[slot] += ΔE[slot]                     (one f32 add, as the TPU kernel)
//   e_rung[rung[slot]] = energy[slot]            (scatter; the one-hot sum's value)
//   u[r] = swap_uniforms(phase)[r], partner[r] from DEO parity or the SEO coin
//   p[r] = swap_probability(betas[r], betas[partner], e_rung[r], e_rung[partner])
//   decision at the lower rung, perm[r], rung'[slot] = perm[rung[slot]]
//   row k of the (K, R) accept / prob / attempt diagnostics.
// Three stages separated by __syncthreads(): the scatter, the decisions
// (each pair's lower rung also writes both rungs' perm entries, so no stage
// of its own is needed for perm), and rung' = perm[rung].  The rows between
// them live in a small global scratch buffer (kScratchBytes a replica, in
// L2), so the sweep launch keeps its own shared memory, occupancy and limit
// on R.
//
// Why in the sweep launch.  On the TPU a round is one pallas_call: the whole
// ladder is one grid step, the sweeps and exchange_step one body.  Here the
// sweeps span one block per slot (or per #2p group) and the exchange needs
// every block's ΔE: a grid-wide barrier, which a launch of 1,500 blocks
// cannot hold (not all are resident at once).  The last block to finish
// needs no barrier: every block, after storing its ΔE, takes a ticket with
// one acq_rel atomic add (release: its ΔE before its ticket); the block that
// takes the last one has acquired every other block's ΔE, and it runs the
// exchange.  No block waits for another.  Which block is last changes
// nothing: the exchange reads only rows that every block has finished
// writing.  The scaffold (checkerboard::sweeps) takes the ticket; each
// kernel calls exchange_if_last once, after its sweeps.  The earlier
// design (kernel B, exchange.cu) was a second launch per round behind its
// own host wrapper: ~5.5 µs of device time and ~30 µs of host time a round
// for ~45 KB of rows.
//
// The ticket is one uint32 per chain, device and stream, zero between
// launches; the last block sets it back to 0 when its exchange is done, so a
// launch that faults leaves it non-zero for the caller to see.
//
// Chain axis.  A launch may carry C independent chains (an ensemble, or a
// serve bucket of C tenants) as the grid's second dimension, gridDim.y = C,
// each chain gridDim.x blocks over its own n slots.  Every per-chain row,
// the phase counter, the scratch and the ticket sit at a fixed offset from
// chain 0's (Round::chain); the betas row is shared, as the JAX engine's
// EngineState.betas has no chain axis.  The last block *of each chain*
// (its ticket counts that chain's gridDim.x blocks) runs that chain's
// exchange, so one launch is one PT round of every chain, as one batched
// pallas_call is under jax.vmap.
//
// Bound.  ~30 B read and written per rung (45 KB at R = 1,500) and R + 3
// Threefry blocks: far below a microsecond of memory or ALU time.  What it
// costs is the launch's tail, and that is latency: one block's dependent
// stages over the rows after the other blocks are done, each stage at least
// one round trip to L2.  A first version (four stages, one row a thread at
// a time, two __threadfence()s around the atomic, the ticket taken after
// the block's lattice store) measured a tail of 6-13 µs on an H100: a
// round launch less the same launch without the exchange.  Here each stage
// issues all of a thread's loads (kItems rows) before its stores, thread 0
// takes the ticket right after the ΔE store while the other threads write
// the lattice back, and the release waits for thread 0's own stores only:
// ~7.0 µs at L=32 R=1500 S=1, of which ~2.5 µs is the ticket alone
// (fused_probe, variants with the one-launch interface; PERF.md §6).
// Tried and dropped there: two __threadfence()s around a relaxed atomicAdd
// (7.3 µs); each block posting its slots' energies (energy', e_rung) before
// its ticket, its energy prefetched to L1 at block start, so that the last
// block starts at the decisions (7.4 µs: every block's ticket then waits on
// the post's stores); two stages, the scatter also recording each rung's
// slot and each pair's lower rung writing both slots' new rungs (8.0 µs).
//
// Numerics.  p is computed with the expressions of torch's CUDA sigmoid /
// exp (1/(1+expf(-x)), fminf(expf(fminf(x,80)),1)) without fast math, so
// expf and the division are libdevice's IEEE routines, as in PyTorch's own
// kernels, and p matches the plain version's torch ops on the card.  The
// sweep sources are built with -fmad=false; nothing here is a product
// followed by a sum that contraction could fuse, and libdevice's expf
// writes its fused steps as explicit fmaf, so p is the same bits under
// either setting (held against the earlier exchange.cu on the card).  JAX
// on the CPU may differ by an ulp; a decision can then flip only when u
// lies between the two p's.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace exchange {

// Scratch bytes a replica: e_rung, perm.  Each library that runs the
// exchange exports it as exchange_scratch_bytes(), and the wrapper sizes the
// buffer from that, so a layout change here cannot outgrow the buffer.
constexpr int kScratchBytes = 2 * 4;
// Rows a thread takes per pass of a stage: all their loads are issued before
// any of their stores, so a pass costs one memory round trip, not kItems.
constexpr int kItems = 4;

// The exchange arguments of a round launch.  A null ticket means none: the
// interval-fused path, which runs the same kernels without an exchange.
struct Round {
  const int32_t* rung_in;  // slot -> rung; may alias rung_out
  int32_t* rung_out;
  const float* energy_in;  // per slot; may alias energy_out
  float* energy_out;
  const float* betas;  // rung order
  const int64_t* phase0;
  long long phase_add;
  int n, seo, metropolis;
  bool* acc_row;
  float* prob_row;
  bool* att_row;
  unsigned char* scratch;  // kScratchBytes * n bytes of global memory
  unsigned int* ticket;

  // Chain c of a launch over a chain axis (gridDim.y = C chains of n slots):
  // its rows, phase counter, scratch and ticket, each a fixed offset from
  // chain 0's; the betas row is shared.  A null ticket stays null.
  __device__ __forceinline__ Round chain(int c) const {
    return ticket == nullptr ? *this : at(c);
  }

  // Chain c's rows, whatever the ticket (the standalone launch has none; a
  // null energy_out, ticket or row stays null at every chain).
  __device__ __forceinline__ Round at(int c) const {
    const size_t o = static_cast<size_t>(c) * n;
    return {rung_in + o, rung_out + o, energy_in + o,
            energy_out == nullptr ? nullptr : energy_out + o, betas, phase0 + c,
            phase_add, n, seo, metropolis, acc_row + o, prob_row + o, att_row + o,
            scratch + o * kScratchBytes, ticket == nullptr ? nullptr : ticket + c};
  }
};

// The launchers' C arguments as a Round (n = the launch's replica count).
inline Round make_round(const void* rung_in, void* rung_out, const void* energy_in,
                        void* energy_out, const void* betas, const void* phase0,
                        long long phase_add, int n, int seo, int metropolis, void* acc_row,
                        void* prob_row, void* att_row, void* scratch, void* ticket) {
  return {static_cast<const int32_t*>(rung_in), static_cast<int32_t*>(rung_out),
          static_cast<const float*>(energy_in), static_cast<float*>(energy_out),
          static_cast<const float*>(betas), static_cast<const int64_t*>(phase0), phase_add,
          n, seo, metropolis, static_cast<bool*>(acc_row), static_cast<float*>(prob_row),
          static_cast<bool*>(att_row), static_cast<unsigned char*>(scratch),
          static_cast<unsigned int*>(ticket)};
}

__device__ __forceinline__ int partner_of(int r, int parity, int n) {
  int p = parity == 0 ? (r ^ 1) : (r == 0 ? 0 : (((r - 1) ^ 1) + 1));
  return p >= n ? r : p;
}

// The swap stream of one exchange: the phase's word key (ss, then wk) and
// the pairing's parity (DEO: the phase's; SEO: the phase coin), three
// Threefry blocks in series.
struct SwapKeys {
  threefry::Pair wk;
  int parity;
};

__device__ __forceinline__ SwapKeys swap_keys(const int64_t* key_words, uint32_t phase,
                                              int seo) {
  const threefry::Pair ss = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::SWAP_DOMAIN, threefry::SWAP_DOMAIN);
  const threefry::Pair wk = threefry::hash(ss.x0, ss.x1, phase, 0u);
  const int parity = seo ? static_cast<int>(threefry::hash(wk.x0, wk.x1, 1u, 0u).x0 & 1u)
                         : static_cast<int>(phase & 1u);
  return {wk, parity};
}

// u[r] of the swap stream (prng.swap_uniforms)
__device__ __forceinline__ float swap_uniform(const SwapKeys& k, int r) {
  return threefry::to_uniform(threefry::hash(k.wk.x0, k.wk.x1, 0u, static_cast<uint32_t>(r)).x0);
}

// p of the pair (r, q) (swap_lib.swap_probability, torch's CUDA expressions)
__device__ __forceinline__ float swap_probability(float br, float bq, float er, float eq,
                                                  int metropolis) {
  const float arg = (br - bq) * (er - eq);
  return metropolis ? fminf(expf(fminf(arg, 80.0f)), 1.0f) : 1.0f / (1.0f + expf(-arg));
}

// One exchange over the rows, by the threads of one block, in three stages
// separated by __syncthreads(); each stage walks the rows in passes of
// kItems a thread.  `de` is the launch's ΔE row, written by every block; it
// is read from L2 (__ldcg).  In place: a slot's rung and energy are read by
// the thread that writes them, before it writes them.  kDelta = false is
// the standalone launch's variant for rows past shared memory
// (exchange_step.cu): energy_in already holds the interval's energies,
// nothing is added and energy_out is not written.
template <bool kDelta = true>
__device__ __forceinline__ void step(const Round& rd, const float* de,
                                     const int64_t* key_words) {
  const int n = rd.n, stride = blockDim.x;
  float* e_rung = reinterpret_cast<float*>(rd.scratch);
  int* perm = reinterpret_cast<int*>(e_rung + n);

  // energy' = energy + ΔE, scattered to rung order
  for (int base = threadIdx.x; base < n; base += kItems * stride) {
    int r[kItems];
    float e[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k * stride;
      if (i < n) {
        r[k] = rd.rung_in[i];
        e[k] = kDelta ? rd.energy_in[i] + __ldcg(de + i) : rd.energy_in[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k * stride;
      if (i < n) {
        e_rung[r[k]] = e[k];
        if (kDelta) rd.energy_out[i] = e[k];
      }
    }
  }
  const SwapKeys keys =
      swap_keys(key_words, static_cast<uint32_t>(rd.phase0[0] + rd.phase_add), rd.seo);
  __syncthreads();

  // the decision at each pair's lower rung, which also writes both rungs'
  // entries of perm (an unpaired rung keeps its own)
  for (int base = threadIdx.x; base < n; base += kItems * stride) {
    int q[kItems];
    float br[kItems], bq[kItems], er[kItems], eq[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = base + k * stride;
      if (r < n) {
        q[k] = partner_of(r, keys.parity, n);
        br[k] = rd.betas[r];
        bq[k] = rd.betas[q[k]];
        er[k] = e_rung[r];
        eq[k] = e_rung[q[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int r = base + k * stride;
      if (r < n) {
        const float p = swap_probability(br[k], bq[k], er[k], eq[k], rd.metropolis);
        const bool is_lower = q[k] != r && r < q[k];
        const float u = swap_uniform(keys, r);
        const bool acc = (u < p) && is_lower;
        rd.acc_row[r] = acc;
        rd.prob_row[r] = is_lower ? p : 0.0f;
        rd.att_row[r] = is_lower;
        if (is_lower) {
          perm[r] = acc ? q[k] : r;
          perm[q[k]] = acc ? r : q[k];
        } else if (q[k] == r) {
          perm[r] = r;
        }
      }
    }
  }
  __syncthreads();

  // rung'[slot] = perm[rung[slot]]
  for (int base = threadIdx.x; base < n; base += kItems * stride) {
    int r[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k * stride;
      if (i < n) r[k] = perm[rd.rung_in[i]];
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k * stride;
      if (i < n) rd.rung_out[i] = r[k];
    }
  }
}

// Thread 0 of every block, right after its block's ΔE store, while the other
// threads write the lattice back: one acq_rel atomic add on the ticket
// (release: the block's ΔE before its ticket; acquire, in the last block:
// every other block's ΔE); returns whether the block took the last ticket.
// The release waits for this thread's own stores only (the block's lattice
// store, which the exchange never reads, is not ordered before it).  `rd` is
// the block's chain's (Round::chain): its ticket counts the gridDim.x blocks
// of that chain alone.
__device__ __forceinline__ bool take_ticket(const Round& rd) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(rd.ticket)
               : "memory");
  return old == gridDim.x - 1;
}

// Every thread of every block, once, after the sweeps (checkerboard::sweeps
// leaves take_ticket's answer in `flag`, one int of shared memory that the
// block no longer uses): the last block runs the exchange and sets the
// ticket back to 0; every other block is done.
__device__ __forceinline__ void exchange_if_last(const Round& rd, const float* de,
                                                 const int64_t* key_words, const int* flag) {
  __syncthreads();
  if (!*flag) return;
  step(rd, de, key_words);
  if (threadIdx.x == 0) *rd.ticket = 0u;
}

}  // namespace exchange
