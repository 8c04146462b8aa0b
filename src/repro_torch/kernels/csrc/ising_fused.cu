// Kernel A: S checkerboard Ising sweeps per launch, lattice resident in
// shared memory, Threefry uniforms drawn in-kernel.
//
// Replaces (TPU, Pallas):
//   repro/kernels/ising_sweep.py::ising_sweep_fused_pallas
//     (_ising_sweep_fused_kernel, _ising_sweep_body), and the sweep half of
//   repro/kernels/ising_sweep.py::ising_round_fused_pallas
//     (_ising_round_fused_kernel).
//
// Design.  One block per replica slot holds the whole L x L int8 lattice in
// dynamic shared memory for all S sweeps (the VMEM-resident tile rethought
// for an SM: 90,000 B at the paper's L = 300, two blocks per SM).  256
// threads stride over the active colour's L^2/2 sites; a site's uniform is
// threefry(sweep key, (colour, i*L + j)), which depends on no other site, so
// each thread hashes only the sites it updates.  __syncthreads() separates
// the colours.  The slot's beta is betas[rung[slot]], read in-kernel from
// the device rung map, so the interval-fused path (identity rung, per-slot
// betas) and the whole-round path (rung-ordered betas) share this kernel.
//
// Acceptance.  The kernel does no expf per site.  The wrapper builds, once
// per launch and with the plain version's own torch ops, the 10-entry rows
//   de_tab[s][n]  = 2*s*(j*nbr - b)            s in {-1,+1}, nbr in {-4..4 step 2}
//   p_tab[r][s][n] = accept_prob(de_tab, betas[r])
// and the kernel selects from them.  Spins and acceptance counts are
// therefore bit-equal to the plain version by construction, for any j, b
// and rule.  Per-colour ΔE partial sums are reduced in a fixed order (warp
// shuffles, then warps in index order; no atomics) and accumulated as the
// JAX kernel does: per colour into the sweep, then per sweep.  At j=1, b=0
// every term is an integer and the sum is exact; otherwise only the order
// inside one colour's sum differs from the plain version.
//
// Bound.  At L=300, R=1500, S=100 a launch moves 2 B/cell (270 MB, about
// 80 us at 3.35 TB/s) but evaluates 1.35e10 Threefry-20 blocks of 72
// 32-bit integer instructions each (2 counter adds, 20 rounds of add,
// funnel-shift rotate and xor, 5 key injections of 2 adds): 9.7e11
// instructions, 29 ms at Hopper's issue rate of 33.5e12/s (128 lanes per
// SM x 132 SMs x 1.98 GHz; integer adds also issue on the FMA pipe).  It is
// integer-ALU bound, by more than two orders of magnitude.  The design therefore spends nothing on memory (one
// read and one write of the lattice per launch, tables in shared memory)
// and hashes exactly one block per site update, the minimum the stream
// allows.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// fast math), see repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "lattice.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// shared-memory header: float/int reduction scratch + the two 10-entry tables
constexpr int kHeaderBytes = kWarps * 4 * 2 + 10 * 4 * 2;

// spins_in may alias spins_out: a block reads its whole lattice into shared
// memory before it writes anything back.
__global__ void __launch_bounds__(kThreads)
ising_fused_kernel(const int8_t* spins_in, int8_t* spins_out,
                   float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                   const int32_t* __restrict__ rung,
                   const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab,
                   const int64_t* __restrict__ key_words,
                   const int64_t* __restrict__ t0, long long t_add,
                   unsigned int replica_offset, int L, int n_sweeps) {
  extern __shared__ unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  float* p_s = reinterpret_cast<float*>(smem + kWarps * 8);
  float* de_s = p_s + 10;
  int8_t* lat = reinterpret_cast<int8_t*>(smem + kHeaderBytes);

  const int slot = blockIdx.x;
  const int LL = L * L;
  const int8_t* src = spins_in + static_cast<size_t>(slot) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) lat[i] = src[i];
  if (threadIdx.x < 10) {
    p_s[threadIdx.x] = p_tab[rung[slot] * 10 + threadIdx.x];
    de_s[threadIdx.x] = de_tab[threadIdx.x];
  }

  const threefry::Pair sk = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::DOMAIN, threefry::DOMAIN);
  const uint32_t t_base = static_cast<uint32_t>(t0[0] + t_add);
  const uint32_t rep = static_cast<uint32_t>(slot) + replica_offset;
  const int n_colour = LL / 2;
  float de_total = 0.0f;
  int nacc = 0;
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    const threefry::Pair wk =
        threefry::hash(sk.x0, sk.x1, t_base + static_cast<uint32_t>(sweep), rep);
    float ds = 0.0f;
    for (int c = 0; c < 2; ++c) {
      float part = 0.0f;
      for (int idx = threadIdx.x; idx < n_colour; idx += blockDim.x) {
        const lattice::Site st = lattice::colour_site(idx, c, L, L);
        const int nbr = lat[st.up] + lat[st.dn] + lat[st.lf] + lat[st.rt];
        const int sv = lat[st.site];
        const int k = (sv > 0 ? 5 : 0) + ((nbr + 4) >> 1);
        const float u = threefry::to_uniform(
            threefry::hash(wk.x0, wk.x1, static_cast<uint32_t>(c),
                           static_cast<uint32_t>(st.site)).x0);
        if (u < p_s[k]) {
          lat[st.site] = static_cast<int8_t>(-sv);
          part += de_s[k];
          ++nacc;
        }
      }
      // the reduction's barriers also end this colour before the next reads it
      const float colour_sum = block_reduce::sum<kWarps>(part, fred);
      ds = ds + colour_sum;
    }
    de_total = de_total + ds;
  }
  const int nacc_total = block_reduce::sum<kWarps>(nacc, ired);

  int8_t* dst = spins_out + static_cast<size_t>(slot) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) dst[i] = lat[i];
  if (threadIdx.x == 0) {
    de_out[slot] = de_total;
    nacc_out[slot] = nacc_total;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one launch needs at lattice side L.
long long ising_fused_smem_bytes(int length) {
  return kHeaderBytes + static_cast<long long>(length) * length;
}

// Launches kernel A on `stream`; returns cudaGetLastError() (0 = launched).
int ising_fused_launch(const void* spins_in, void* spins_out, void* de_out,
                       void* nacc_out, const void* rung, const void* p_tab,
                       const void* de_tab, const void* key_words, const void* t0,
                       long long t_add, unsigned int replica_offset,
                       int n_replicas, int length, int n_sweeps, void* stream) {
  const int smem = static_cast<int>(ising_fused_smem_bytes(length));
  cudaError_t err = cudaFuncSetAttribute(
      ising_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ising_fused_kernel<<<n_replicas, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, length, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
