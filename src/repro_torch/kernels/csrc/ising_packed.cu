// Kernel #2p: kernel A's S checkerboard Ising sweeps per launch, with the
// spins of 8 replicas packed into the bits of one byte (multispin coding).
//
// Replaces (TPU, Pallas):
//   repro/kernels/ising_sweep.py::_ising_sweep_body_packed (with _pack_spins,
//     _unpack_spins, _majority, _sel_cnt, _ising_de_tables), the pack_bits
//     body of ising_sweep_fused_pallas and of ising_round_fused_pallas.
//
// Interface.  Kernel A's, argument for argument: int8 (R, L, L) spins in and
// out (they may alias), ΔE f32 (R,), nacc i32 (R,), the rung map, the
// per-rung p rows and the 10-entry ΔE row the wrapper builds with the plain
// version's ops, the run-key words and the device sweep counter.  The slot's
// beta is betas[rung[slot]], read in-kernel, so one kernel serves the
// interval-fused path (identity rung) and, followed by the unchanged kernel
// B, the whole-round path.  The engine's state stays int8: a block packs on
// load and unpacks on store, as the JAX kernel does.
//
// Word width.  The JAX kernel packs 32 replicas into a uint32 plane.  On an
// SM a 32-replica plane at the paper's L = 300 takes 4 L^2 = 360 KB of
// shared memory, over the 227 KB a block may hold.  A byte holds up to 8
// replicas: L^2 = 90,000 B, kernel A's own tile and its L limit (about 476),
// so this kernel runs every L and R that kernel A runs.  One block owns one
// group of `group` <= 8 consecutive replicas (slots g*group ..); bits of
// different replicas never interact, so the only synchronisation is kernel
// A's __syncthreads() between colours.  The last group may be partial
// (R = 1500 is 187 x 8 + 4, the conformance entry has R = 5): the block's
// width is a template argument, so its unused bits are never counted,
// drawn for or written back.
//
// Group width.  Two 90 KB blocks fit an SM, so at R = 1500 full bytes make
// 188 blocks on 132 SMs: 56 SMs hold two groups (16 replicas) and 76 hold
// one, where kernel A's busiest SM does 12 replicas over its waves.  The
// wrapper therefore picks the widest group that minimises the busiest
// SM's replica count (6 at R = 1500: 250 blocks, 12 replicas), and a
// caller may fix it.  No result depends on the grouping.
//
// Per site.  A thread loads the site's byte and its four neighbours' once
// for all the group's replicas, forms the up-neighbour count's bit-planes n0, n1, n2
// by a bitwise full adder (the JAX kernel's), and then, per replica bit,
// selects the table entry (spin, count), hashes that replica's uniform,
// compares and sets the flip bit; it writes byte ^ flips.  The per-site
// index arithmetic (lattice::colour_site, an integer division) is paid once
// per group, and the group's Threefry hashes of a site are independent, so
// the compiler can interleave them (instruction-level parallelism that
// kernel A's one dependent hash per site lacks).
//
// Stream and sums.  Replica k of the group draws kernel A's uniform,
// to_uniform(hash(sweep_key(t0 + sweep, first + k + replica_offset),
// colour, site).x0), where `first` is the group's first slot.  With kThreads = 256, kernel A's block size, each thread visits
// kernel A's sites in kernel A's order, so each replica's ΔE partial sum is
// kernel A's, and the fixed-order reductions (block_reduce.cuh, per colour,
// then per sweep) are kernel A's too: spins, nacc and ΔE equal kernel A's
// bit for bit, for any j and b.
//
// Bound.  Kernel A's: the Threefry work, one block per site update (72
// 32-bit instructions each), is 29.055 ms at L=300, R=1500, S=100 on the
// instruction-issue rate; the lattice moves once each way (2 B/cell).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast math), see repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "lattice.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;  // kernel A's: keeps ΔE bit-equal to it
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // replicas a byte can hold
// shared-memory header: float/int reduction scratch, the group's p rows and
// the ΔE row
constexpr int kHeaderBytes = kWarps * 4 * 2 + (kGroup * 10 + 10) * 4;

// S sweeps of one group of kBits replicas starting at slot `first`.
template <int kBits>
__device__ __forceinline__ void group_sweeps(
    unsigned char* smem, const int8_t* spins_in, int8_t* spins_out,
    float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
    const int32_t* __restrict__ rung, const float* __restrict__ p_tab,
    const float* __restrict__ de_tab, const int64_t* __restrict__ key_words,
    const int64_t* __restrict__ t0, long long t_add, unsigned int replica_offset,
    int first, int L, int n_sweeps) {
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  float* p_s = reinterpret_cast<float*>(smem + kWarps * 8);
  float* de_s = p_s + kGroup * 10;
  uint8_t* lat = smem + kHeaderBytes;

  const int LL = L * L;
  const int8_t* src = spins_in + static_cast<size_t>(first) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) {
    unsigned int w = 0;
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      w |= static_cast<unsigned int>(src[static_cast<size_t>(k) * LL + i] > 0) << k;
    }
    lat[i] = static_cast<uint8_t>(w);
  }
  for (int i = threadIdx.x; i < kBits * 10; i += blockDim.x) {
    p_s[i] = p_tab[rung[first + i / 10] * 10 + i % 10];
  }
  if (threadIdx.x < 10) de_s[threadIdx.x] = de_tab[threadIdx.x];

  const threefry::Pair sk = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::DOMAIN, threefry::DOMAIN);
  const uint32_t t_base = static_cast<uint32_t>(t0[0] + t_add);
  const uint32_t rep0 = static_cast<uint32_t>(first) + replica_offset;
  const int n_colour = LL / 2;
  float de_total[kBits];
  int nacc[kBits];
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    de_total[k] = 0.0f;
    nacc[k] = 0;
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    threefry::Pair wk[kBits];
    float ds[kBits];
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      wk[k] = threefry::hash(sk.x0, sk.x1, t_base + static_cast<uint32_t>(sweep),
                             rep0 + static_cast<uint32_t>(k));
      ds[k] = 0.0f;
    }
    for (int c = 0; c < 2; ++c) {
      float part[kBits];
#pragma unroll
      for (int k = 0; k < kBits; ++k) part[k] = 0.0f;
      for (int idx = threadIdx.x; idx < n_colour; idx += blockDim.x) {
        const lattice::Site st = lattice::colour_site(idx, c, L, L);
        const unsigned int w = lat[st.site];
        const unsigned int up = lat[st.up], dn = lat[st.dn];
        const unsigned int lf = lat[st.lf], rt = lat[st.rt];
        // up-neighbour count cnt = n0 + 2*n1 + 4*n2, bitwise full adder
        const unsigned int s0 = up ^ dn, c0 = up & dn;
        const unsigned int s1 = lf ^ rt, c1 = lf & rt;
        const unsigned int n0 = s0 ^ s1, c2 = s0 & s1;
        const unsigned int n1 = c0 ^ c1 ^ c2;
        const unsigned int n2 = (c0 & c1) | (c0 & c2) | (c1 & c2);
        unsigned int flips = 0;
#pragma unroll
        for (int k = 0; k < kBits; ++k) {
          const int e = 5 * ((w >> k) & 1u) + ((n0 >> k) & 1u) +
                        2 * ((n1 >> k) & 1u) + 4 * ((n2 >> k) & 1u);
          const float u = threefry::to_uniform(
              threefry::hash(wk[k].x0, wk[k].x1, static_cast<uint32_t>(c),
                             static_cast<uint32_t>(st.site)).x0);
          if (u < p_s[k * 10 + e]) {
            flips |= 1u << k;
            part[k] += de_s[e];
            ++nacc[k];
          }
        }
        lat[st.site] = static_cast<uint8_t>(w ^ flips);
      }
      // the reductions' barriers also end this colour before the next reads it
#pragma unroll
      for (int k = 0; k < kBits; ++k) {
        const float colour_sum = block_reduce::sum<kWarps>(part[k], fred);
        ds[k] = ds[k] + colour_sum;
      }
    }
#pragma unroll
    for (int k = 0; k < kBits; ++k) de_total[k] = de_total[k] + ds[k];
  }
  int nacc_total[kBits];
#pragma unroll
  for (int k = 0; k < kBits; ++k) {
    nacc_total[k] = block_reduce::sum<kWarps>(nacc[k], ired);
  }

  int8_t* dst = spins_out + static_cast<size_t>(first) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) {
    const unsigned int w = lat[i];
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      dst[static_cast<size_t>(k) * LL + i] = ((w >> k) & 1u) ? int8_t(1) : int8_t(-1);
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kBits; ++k) {
      de_out[first + k] = de_total[k];
      nacc_out[first + k] = nacc_total[k];
    }
  }
}

// spins_in may alias spins_out: a block reads its group's lattices into
// shared memory before it writes anything back, and touches no other group.
__global__ void __launch_bounds__(kThreads)
ising_packed_kernel(const int8_t* spins_in, int8_t* spins_out,
                    float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                    const int32_t* __restrict__ rung,
                    const float* __restrict__ p_tab,
                    const float* __restrict__ de_tab,
                    const int64_t* __restrict__ key_words,
                    const int64_t* __restrict__ t0, long long t_add,
                    unsigned int replica_offset, int n_replicas, int group,
                    int L, int n_sweeps) {
  extern __shared__ unsigned char smem[];
  const int first = blockIdx.x * group;
  const int bits = n_replicas - first < group ? n_replicas - first : group;
#define REPRO_GROUP(K)                                                           \
  case K:                                                                        \
    group_sweeps<K>(smem, spins_in, spins_out, de_out, nacc_out, rung, p_tab,    \
                    de_tab, key_words, t0, t_add, replica_offset, first, L,      \
                    n_sweeps);                                                   \
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
}

}  // namespace

extern "C" {

// Shared-memory bytes one launch needs at lattice side L.
long long ising_packed_smem_bytes(int length) {
  return kHeaderBytes + static_cast<long long>(length) * length;
}

// Threads per block of every launch.
int ising_packed_threads() { return kThreads; }

// Launches kernel #2p on `stream`, one block per `group` (1..8) replicas;
// returns cudaGetLastError() (0 = launched).
int ising_packed_launch(const void* spins_in, void* spins_out, void* de_out,
                        void* nacc_out, const void* rung, const void* p_tab,
                        const void* de_tab, const void* key_words, const void* t0,
                        long long t_add, unsigned int replica_offset,
                        int n_replicas, int length, int n_sweeps, int group,
                        void* stream) {
  if (group < 1 || group > kGroup) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(ising_packed_smem_bytes(length));
  cudaError_t err = cudaFuncSetAttribute(
      ising_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ising_packed_kernel<<<(n_replicas + group - 1) / group, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, n_replicas, group,
      length, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
