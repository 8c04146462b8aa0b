// The fused checkerboard sweep loop shared by kernel A (ising_fused.cu),
// kernel #5 (potts_fused.cu) and kernel #2p (ising_packed.cu): S sweeps of
// kRep replica slots per block (1 for A and #5; up to 8 for #2p, one bit of
// each shared-memory byte per replica), the lattice resident in shared
// memory, Threefry uniforms drawn in-kernel.  Each kernel supplies only its
// site update (a `Rule`); the layout, the walk over the sites, the sweep
// keys, the reductions and the lattice's one read and one write per launch
// live here once.
//
// Replaces the site loops of (TPU, Pallas) repro/kernels/ising_sweep.py::
// ising_sweep_fused_pallas / ising_round_fused_pallas and repro/kernels/
// potts_sweep.py::potts_sweep_fused_pallas / potts_round_fused_pallas.
//
// Bound.  Threefry-20 work: 72 32-bit instructions per block, one block per
// Ising site update and two per Potts update, at the 128-lane issue rate
// (33.5e12/s on an H100).  A block compiles to 19 rotates, 19 xors and
// ~26 adds once its dead second word is dropped, so the cipher alone is
// about 64 SASS instructions per block; everything else a site update
// issues is overhead on the same issue slots.
//
// What held the first versions back (cuobjdump -sass of their site loops,
// PERF.md §6, fused_probe.py): per Ising update 130 instructions, of which
// ~66 outside the cipher: lattice::colour_site (a runtime division by W/2,
// four wrap selects, five row*W+col products), five signed byte loads at
// stride 2, I2F + FMUL + FSETP per uniform, in Potts a `% q` and eight
// compare/select pairs (253 per Potts update); one dependent cipher chain
// per thread at 256 threads a block.
//
// Design.
// * Layout: colour pairs with a halo.  The lattice is H+2 rows of pitch
//   columns of two bytes: column k+1 of row i+1 holds the colour-0 and the
//   colour-1 site whose j/2 is k.  Site (i, j) of colour c = (i+j)&1 sits at
//   byte c of its cell; its four neighbours are the other colour's bytes of
//   the cells above and below (fixed offsets -2*pitch+o, +2*pitch+o, o =
//   1-2c) and of cells k+par and k+1+par of its row, par = (i+c)&1 = j&1.
//   Rows 0 / H+1 and columns 0 / W/2+1 mirror the far row / column of the
//   torus, so no site pays a wrap select: after each colour its threads
//   refresh that colour's halo (2*(H + W/2) bytes) between the two barriers
//   the colour's ΔE reduction already has.
// * Walk: a thread takes runs of kSites consecutive sites of one row, runs
//   t, t+T, t+2T, ... (T threads) in row-major order, rows padded to whole
//   runs with dead slots that read valid bytes and commit nothing.  The
//   run's row and column advance with one carry compare and no division;
//   its first byte and counter cost a few instructions a run, and inside it
//   every byte and counter is a fixed offset (+2 bytes, +2 per site).
// * The run's kSites updates are independent: their cipher chains
//   interleave (Potts: two per site, proposal and acceptance).
// * The cipher: threefry::hash under the sweep key's schedule, made once
//   per sweep (the second-word injections precomputed); only the first
//   output word is used, so the compiler drops the second one's last steps.
// * Acceptance: u < p with u = (bits >> 8) * 2^-24 exact is (bits >> 8) <
//   ceil(p * 2^24) for every float p (NaN and p <= 0 never accept, p >= 1
//   always); the thresholds are made once per launch from the wrapper's p
//   rows, so a site does a shift and an integer compare, no I2F or FMUL.
// * 512 threads a block, two blocks (two ~92 KB lattices) an SM: the width
//   and the run length came from a sweep of both (fused_probe.py, PERF.md).
//
// * kRep > 1 (#2p): load packs the kRep int8 lattices into one byte per
//   site, bit r for replica r, and store unpacks; the halo and the walk are
//   unchanged.  Each replica keeps its own sweep key schedule (made once
//   per sweep into shared memory by thread r), per-thread ΔE partial and
//   acceptance count; each colour ends with kRep block reductions in
//   replica order.  The rule loops over the replicas inside a run, so a
//   thread's partial sum of replica r adds the same terms in the same order
//   as kernel A's thread does for that slot: ΔE is kernel A's bit for bit.
//
// Invariants.  A site's uniform is to_uniform(hash(sweep_key(t0 + sweep,
// slot + r + replica_offset), plane, i*W + j).x0) for replica r of the
// block, with the plane the rule names; sites of one colour never neighbour
// each other, so the visiting order leaves spins, colours and counts bit for
// bit the plain version's.  ΔE partial sums are reduced per colour in a
// fixed order (block_reduce.cuh, no atomics) and accumulated per colour
// into the sweep, then per sweep, as the JAX kernel does; only the order
// inside one colour's sum is this walk's.  The lattice is read once and
// written once per launch.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "exchange.cuh"
#include "threefry.cuh"

namespace checkerboard {

// One acceptance-table entry: the threshold on the uniform's 24 bits and ΔE.
struct Entry {
  uint32_t thr;
  float de;
};

// ceil(p * 2^24), saturated: (bits >> 8) < threshold(p) iff to_uniform(bits) < p.
__device__ __forceinline__ uint32_t threshold(float p) {
  return static_cast<uint32_t>(ceilf(p * 16777216.0f));
}

__device__ __forceinline__ bool accept(uint32_t bits, uint32_t thr) {
  return __umulhi(bits, 1u << 24) < thr;  // bits >> 8, on the FMA pipe
}

// One site of the active colour, as a rule sees it: its byte and its four
// neighbours' (read by the scaffold, in the rule's shared-memory encoding),
// its Threefry counter i*W + j and its byte's address, which the rule
// writes if the update is accepted; a site that is not `live` (a row's
// padding) reads valid bytes and commits nothing.
struct Site {
  uint32_t v, up, dn, lf, rt;
  uint32_t ctr;
  uint8_t* at;
  bool live;
};

// Columns of a row's colour-c sites rounded up to whole runs of kSites.
template <int kSites>
__host__ __device__ __forceinline__ int run_columns(int W) {
  return (W / 2 + kSites - 1) / kSites * kSites;
}

// Shared-memory bytes of an H x W lattice in the colour-paired haloed layout:
// H + 2 rows of run_columns + 2 columns, two bytes (one per colour) each.
template <int kSites>
inline long long lattice_bytes(int H, int W) {
  return 2LL * (H + 2) * (run_columns<kSites>(W) + 2);
}

// Byte of colour c at padded row r, padded column kk: the two colours of a
// column sit side by side, so a site's other-colour neighbours are at fixed
// offsets from its own byte.
__device__ __forceinline__ int cell(int r, int kk, int pitch, int c) {
  return 2 * (r * pitch + kk) + c;
}

// Row-major position (i, k) in rows of n entries, advanced by a fixed stride
// with one carry compare.  The constructor divides once; step() never does.
// It walks the lattice's sites at load and store and the runs of a colour.
struct Walker {
  int i, k, di, dk, n;
  __device__ Walker(int start, int stride, int n_)
      : i(start / n_), k(start % n_), di(stride / n_), dk(stride % n_), n(n_) {}
  __device__ __forceinline__ void step() {
    k += dk;
    i += di;
    if (k >= n) {
      k -= n;
      ++i;
    }
  }
};

// Scratch of a kRep > 1 block in shared memory: the replicas' sweep key
// schedules and thread 0's per-replica ΔE accumulators.
template <int kRep>
struct Scratch {
  threefry::Schedule ks[kRep];
  float de_sweep[kRep], de_total[kRep];
};

// Column-k halo refresh of colour c: rows 0 / H+1 and columns 0 / half+1
// mirror the far row / column of the torus.
template <int kThreads>
__device__ __forceinline__ void refresh_halo(uint8_t* lat, int c, int H, int half, int pitch) {
  for (int t = threadIdx.x; t < half + H; t += kThreads) {
    if (t < half) {
      lat[cell(0, t + 1, pitch, c)] = lat[cell(H, t + 1, pitch, c)];
      lat[cell(H + 1, t + 1, pitch, c)] = lat[cell(1, t + 1, pitch, c)];
    } else {
      const int r = t - half + 1;
      lat[cell(r, 0, pitch, c)] = lat[cell(r, half, pitch, c)];
      lat[cell(r, half + 1, pitch, c)] = lat[cell(r, 1, pitch, c)];
    }
  }
}

// S sweeps of kRep consecutive slots' H x W lattices (H, W even), the first
// at `slot`, whose int8 lattices start at `src` / `dst`, one after another.
// `lat` is the block's lattice region of lattice_bytes<kSites>(H, W) in
// shared memory, `fred` / `ired` kThreads/32 floats / ints of reduction
// scratch, `scratch` a Scratch<kRep> (unused at kRep = 1); the rule's tables
// must be in shared memory already (the barrier after the load publishes
// them).  The rule maps lattice values to its shared-memory bytes and back
// (`Rule::to_shared`, `Rule::from_shared`; at kRep > 1 a replica's value is
// one bit).  At kRep = 1 the rule's update takes the sweep's key schedule,
// the thread's ΔE partial and count; at kRep > 1 the kRep schedules in
// shared memory and kRep partials and counts.  `src` may alias `dst`: every
// lattice is read before anything is written.  With round arguments (a
// non-null `round.ticket`, a uniform branch the interval-fused path never
// takes) thread 0 takes the round's ticket right after the block's ΔE store,
// while the other threads write the lattice back, and leaves in ired[0]
// whether it was the last; the kernel then calls exchange::exchange_if_last
// (exchange.cuh) once, so the exchange's code is not repeated per kRep.
template <int kThreads, int kSites, int kRep, class Rule>
__device__ __forceinline__ void sweeps(const Rule& rule, uint8_t* lat, float* fred,
                                       int* ired, Scratch<kRep>* scratch,
                                       const int8_t* src, int8_t* dst, float* de_out,
                                       int32_t* nacc_out, int slot,
                                       const int64_t* key_words, const int64_t* t0,
                                       long long t_add, uint32_t rep, int H, int W,
                                       int n_sweeps, const exchange::Round& round) {
  static_assert(kRep >= 1 && kRep <= 8, "a shared-memory byte holds 1..8 replicas");
  constexpr int kWarps = kThreads / 32;
  const int half = W / 2;
  const int cols = run_columns<kSites>(W);
  const int pitch = cols + 2;
  const size_t cells = static_cast<size_t>(H) * W;

  // load: (i, j) -> colour (i+j)&1 at row i+1, column j/2+1, and its mirrors
  for (Walker w(threadIdx.x, kThreads, W); w.i < H; w.step()) {
    const int i = w.i, j = w.k, k = j >> 1, c = (i + j) & 1;
    uint8_t v;
    if constexpr (kRep == 1) {
      v = Rule::to_shared(src[i * W + j]);
    } else {
      uint32_t packed = 0;
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        packed |= static_cast<uint32_t>(Rule::to_shared(src[r * cells + i * W + j])) << r;
      }
      v = static_cast<uint8_t>(packed);
    }
    lat[cell(i + 1, k + 1, pitch, c)] = v;
    if (i == H - 1) lat[cell(0, k + 1, pitch, c)] = v;
    if (i == 0) lat[cell(H + 1, k + 1, pitch, c)] = v;
    if (k == half - 1) lat[cell(i + 1, 0, pitch, c)] = v;
    if (k == 0) lat[cell(i + 1, half + 1, pitch, c)] = v;
  }

  const threefry::Pair sk = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::DOMAIN, threefry::DOMAIN);
  const uint32_t t_base = static_cast<uint32_t>(t0[0] + t_add);
  const Walker runs(threadIdx.x, kThreads, cols / kSites);  // a thread's first run

  // runs t, t+T, t+2T, ... of kSites consecutive sites of one row of colour
  // c; site s of a run is column k0 + s: byte +2s, counter i*W + 2*(k0 + s) + par
  auto colour_runs = [&](int c, auto&& update) {
    const int o = 1 - 2 * c;  // the other colour's byte of a column
    for (Walker w = runs; w.i < H; w.step()) {
      const int k0 = w.k * kSites, par = (w.i + c) & 1;
      uint8_t* at = lat + cell(w.i + 1, k0 + 1, pitch, c);
      const uint8_t* lr = at + 2 * par;
      const int ctr = w.i * W + 2 * k0 + par;
      Site st[kSites];
#pragma unroll
      for (int s = 0; s < kSites; ++s) {
        const uint8_t* a = at + 2 * s;
        st[s] = {a[0], a[o - 2 * pitch], a[o + 2 * pitch], lr[2 * s + o - 2], lr[2 * s + o],
                 static_cast<uint32_t>(ctr + 2 * s), at + 2 * s, s == 0 || k0 + s < half};
      }
      update(st);
    }
  };

  if constexpr (kRep == 1) {
    float de_total = 0.0f;
    int nacc = 0;
    __syncthreads();

    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      const threefry::Pair wk =
          threefry::hash(sk.x0, sk.x1, t_base + static_cast<uint32_t>(sweep), rep);
      const threefry::Schedule ks = threefry::schedule(wk.x0, wk.x1);
      float ds = 0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float part = 0.0f;
        colour_runs(c, [&](const Site (&st)[kSites]) {
          rule.template update<kSites>(st, ks, c, part, nacc);
        });
        // the reduction's first barrier ends this colour's updates, its second
        // publishes the refreshed halo before the next colour reads it
        const float colour_sum = block_reduce::sum<kWarps>(
            part, fred, [&] { refresh_halo<kThreads>(lat, c, H, half, pitch); });
        ds = ds + colour_sum;
      }
      de_total = de_total + ds;
    }
    const int nacc_total = block_reduce::sum<kWarps>(nacc, ired);
    if (threadIdx.x == 0) {
      de_out[slot] = de_total;
      nacc_out[slot] = nacc_total;
      if (round.ticket != nullptr) *ired = exchange::take_ticket(round);
    }

    for (Walker w(threadIdx.x, kThreads, W); w.i < H; w.step()) {
      const int i = w.i, j = w.k;
      dst[i * W + j] = Rule::from_shared(lat[cell(i + 1, (j >> 1) + 1, pitch, (i + j) & 1)]);
    }
  } else {
    float part[kRep];
    int nacc[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) nacc[r] = 0;
    // only thread 0 touches the ΔE accumulators
    if (threadIdx.x == 0) {
#pragma unroll
      for (int r = 0; r < kRep; ++r) scratch->de_total[r] = 0.0f;
    }

    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      // thread r makes replica r's schedule; the barriers ending the last
      // sweep's reductions order it after every read of the old one, and the
      // one below (after the load, at sweep 0) before every read of the new
      if (threadIdx.x < kRep) {
        const threefry::Pair wk = threefry::hash(
            sk.x0, sk.x1, t_base + static_cast<uint32_t>(sweep), rep + threadIdx.x);
        scratch->ks[threadIdx.x] = threefry::schedule(wk.x0, wk.x1);
      }
      if (threadIdx.x == 0) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) scratch->de_sweep[r] = 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) part[r] = 0.0f;
        colour_runs(c, [&](const Site (&st)[kSites]) {
          rule.template update<kSites>(st, scratch->ks, c, part, nacc);
        });
        // the first reduction's first barrier ends this colour's updates;
        // its second publishes the refreshed halo
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float colour_sum = block_reduce::sum<kWarps>(part[r], fred, [&] {
            if (r == 0) refresh_halo<kThreads>(lat, c, H, half, pitch);
          });
          if (threadIdx.x == 0) scratch->de_sweep[r] = scratch->de_sweep[r] + colour_sum;
        }
      }
      if (threadIdx.x == 0) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          scratch->de_total[r] = scratch->de_total[r] + scratch->de_sweep[r];
        }
      }
    }
    int nacc_total[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) nacc_total[r] = block_reduce::sum<kWarps>(nacc[r], ired);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        de_out[slot + r] = scratch->de_total[r];
        nacc_out[slot + r] = nacc_total[r];
      }
      if (round.ticket != nullptr) *ired = exchange::take_ticket(round);
    }

    for (Walker w(threadIdx.x, kThreads, W); w.i < H; w.step()) {
      const int i = w.i, j = w.k;
      const uint32_t v = lat[cell(i + 1, (j >> 1) + 1, pitch, (i + j) & 1)];
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        dst[r * cells + i * W + j] = Rule::from_shared(static_cast<uint8_t>((v >> r) & 1u));
      }
    }
  }
}

}  // namespace checkerboard
