// Kernel #5: S checkerboard q-state Potts sweeps per launch, lattice
// resident in shared memory, Threefry uniforms drawn in-kernel.
//
// Replaces (TPU, Pallas):
//   repro/kernels/potts_sweep.py::potts_sweep_fused_pallas
//     (_potts_sweep_fused_kernel, _potts_sweep_body), and the sweep half of
//   repro/kernels/potts_sweep.py::potts_round_fused_pallas
//     (_potts_round_fused_kernel; its exchange half is kernel B, exchange.cu).
// Both pack_bits settings of the JAX kernel run here: the lattice is int8
// throughout, which is what pack_bits=True asks for (q <= 64), and the JAX
// package pins the two trajectories as bitwise equal.
//
// Design: kernel A's (ising_fused.cu).  One block per replica slot holds the
// H x W int8 lattice in dynamic shared memory for all S sweeps; 256 threads
// stride over the active colour's sites; each site update hashes two
// Threefry blocks of the sweep key, plane 2*colour (proposal) and plane
// 2*colour+1 (acceptance), at counter i*W + j, which depend on no other
// site.  The slot's beta is betas[rung[slot]], so the interval path
// (identity rung, per-slot betas) and the round path (rung-ordered betas)
// share this kernel.  ΔE and counts are reduced per colour in a fixed order
// and accumulated per colour into the sweep, then per sweep, as the JAX
// kernel does.  Acceptance selects from the 81-entry ΔE row and the
// per-rung p row the wrapper builds with the plain version's ops (see
// sweep.cu), so colours and counts equal the plain version's for any j and
// rule.
//
// Bound.  At H=W=300, R=1500, S=100: 2 Threefry-20 blocks of 72 32-bit
// instructions per site update, 2.7e10 blocks, 1.9e12 instructions, 58 ms
// at Hopper's issue rate of 33.5e12/s (see ising_fused.cu), against 270 MB
// of lattice traffic
// (0.08 ms at 3.35 TB/s).  Integer-ALU bound; the design hashes exactly the
// two blocks per update that the stream defines and nothing else.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "lattice.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeaderBytes = kWarps * 8 + 2 * lattice::kPottsTable * 4;

// states_in may alias states_out: a block reads its whole lattice first.
__global__ void __launch_bounds__(kThreads)
potts_fused_kernel(const int8_t* states_in, int8_t* states_out,
                   float* __restrict__ de_out, int32_t* __restrict__ nacc_out,
                   const int32_t* __restrict__ rung, const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab,
                   const int64_t* __restrict__ key_words,
                   const int64_t* __restrict__ t0, long long t_add,
                   unsigned int replica_offset, int H, int W, int q, int n_sweeps) {
  extern __shared__ unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  float* p_s = reinterpret_cast<float*>(smem + kWarps * 8);
  float* de_s = p_s + lattice::kPottsTable;
  int8_t* lat = reinterpret_cast<int8_t*>(smem + kHeaderBytes);

  const int slot = blockIdx.x;
  const int HW = H * W;
  const int8_t* src = states_in + static_cast<size_t>(slot) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) lat[i] = src[i];
  const float* p_row = p_tab + static_cast<size_t>(rung[slot]) * lattice::kPottsTable;
  for (int i = threadIdx.x; i < lattice::kPottsTable; i += blockDim.x) {
    p_s[i] = p_row[i];
    de_s[i] = de_tab[i];
  }

  const threefry::Pair sk = threefry::hash(
      static_cast<uint32_t>(key_words[0]), static_cast<uint32_t>(key_words[1]),
      threefry::DOMAIN, threefry::DOMAIN);
  const uint32_t t_base = static_cast<uint32_t>(t0[0] + t_add);
  const uint32_t rep = static_cast<uint32_t>(slot) + replica_offset;
  float de_total = 0.0f;
  int nacc = 0;
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    const threefry::Pair wk =
        threefry::hash(sk.x0, sk.x1, t_base + static_cast<uint32_t>(sweep), rep);
    float ds = 0.0f;
    for (int c = 0; c < 2; ++c) {
      float part = 0.0f;
      for (int idx = threadIdx.x; idx < HW / 2; idx += blockDim.x) {
        const lattice::Site st = lattice::colour_site(idx, c, H, W);
        const uint32_t site = static_cast<uint32_t>(st.site);
        const float u_prop = threefry::to_uniform(
            threefry::hash(wk.x0, wk.x1, static_cast<uint32_t>(2 * c), site).x0);
        const float u_acc = threefry::to_uniform(
            threefry::hash(wk.x0, wk.x1, static_cast<uint32_t>(2 * c + 1), site).x0);
        lattice::potts_trial(lat, st, u_prop, u_acc, q, p_s, de_s, part, nacc);
      }
      // the reduction's barriers also end this colour before the next reads it
      ds = ds + block_reduce::sum<kWarps>(part, fred);
    }
    de_total = de_total + ds;
  }
  const int nacc_total = block_reduce::sum<kWarps>(nacc, ired);

  int8_t* dst = states_out + static_cast<size_t>(slot) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) dst[i] = lat[i];
  if (threadIdx.x == 0) {
    de_out[slot] = de_total;
    nacc_out[slot] = nacc_total;
  }
}

}  // namespace

extern "C" {

long long potts_fused_smem_bytes(int height, int width) {
  return kHeaderBytes + static_cast<long long>(height) * width;
}

// Launches kernel #5 on `stream`; returns cudaGetLastError() (0 = launched).
int potts_fused_launch(const void* states_in, void* states_out, void* de_out,
                       void* nacc_out, const void* rung, const void* p_tab,
                       const void* de_tab, const void* key_words, const void* t0,
                       long long t_add, unsigned int replica_offset, int n_replicas,
                       int height, int width, int q, int n_sweeps, void* stream) {
  const int smem = static_cast<int>(potts_fused_smem_bytes(height, width));
  cudaError_t err = cudaFuncSetAttribute(
      potts_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  potts_fused_kernel<<<n_replicas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(states_in), static_cast<int8_t*>(states_out),
      static_cast<float*>(de_out), static_cast<int32_t*>(nacc_out),
      static_cast<const int32_t*>(rung), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t0), t_add, replica_offset, height, width, q,
      n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
