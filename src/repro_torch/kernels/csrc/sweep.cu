// Kernels #1 and #4: one checkerboard sweep per launch, uniforms read from
// device memory.
//
// Replaces (TPU, Pallas):
//   #1 repro/kernels/ising_sweep.py::ising_sweep_pallas (_ising_sweep_kernel)
//   #4 repro/kernels/potts_sweep.py::potts_sweep_pallas (_potts_sweep_kernel)
// They carry the engine's default per-sweep path, whose uniforms come from
// jax.random (jax_uniform.cu) and are passed in: Ising u is (R, 2, L, L),
// one plane per colour; Potts u is (R, 2, 2, H, W), colour x (proposal,
// acceptance).
//
// Design.  One block per replica holds the replica's int8 lattice in
// shared memory (90,000 B at 300 x 300, opt-in above 48 KB, so two blocks
// per SM); 1024 threads stride over one colour's sites, __syncthreads()
// separates the colours, and the lattice is read and written once per
// launch.  The work per site is a few loads, so the kernel lives on memory
// latency: 1024 threads fill the SM's 64 warps with the two blocks that fit
// (the first version, with 256 threads, took 2.1 to 2.5 times as long at
// L=300; PERF.md).
// ΔE and the acceptance count are reduced per colour in a fixed order
// (block_reduce.cuh, no atomics) and added as the plain version adds them:
// colour 0, then 1.
//
// Acceptance.  No expf or sigmoid here.  The wrapper builds, with the plain
// version's own torch ops on the device, a ΔE row and a per-replica p row:
//   Ising: 10 entries (s in {-1,+1}) x (neighbour sum in {-4..4 step 2});
//   Potts: 81 entries, one per tuple of the four direction terms
//          [s == nbr] - [trial == nbr] in {-1, 0, +1}, ΔE summed over
//          up, down, left, right in the plain version's order.
// The kernel selects from them, so spins/colours and counts equal the plain
// version's by construction, for any j, b and rule.
//
// Bound.  Memory: each launch reads the lattice and its uniforms once and
// writes the lattice once: Ising 2 + 8 B per cell (1.35 GB at L=300,
// R=1500: 0.40 ms at 3.35 TB/s), Potts 2 + 16 B per cell (0.73 ms).  The
// per-site work is a few dozen integer operations, far below that.  A
// colour reads every other float of its plane, so a warp's loads are 8-byte
// strided and fetch whole sectors: the unused half is the plane's entries at
// the other colour's sites, which no one reads, so the bytes fetched are
// still the planes once each.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false (no
// contraction of u * (q-1) or of the table's ΔE sums).
#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "lattice.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIsingTable = 10;
// shared-memory header: float + int reduction scratch, then the tables
constexpr int kIsingHeader = kWarps * 8 + 2 * kIsingTable * 4;
constexpr int kPottsHeader = kWarps * 8 + 2 * lattice::kPottsTable * 4;

__global__ void __launch_bounds__(kThreads)
ising_sweep_kernel(const int8_t* __restrict__ spins_in,
                   int8_t* __restrict__ spins_out,
                   const float* __restrict__ u, float* __restrict__ de_out,
                   int32_t* __restrict__ nacc_out, const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab, int L) {
  extern __shared__ unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  float* p_s = reinterpret_cast<float*>(smem + kWarps * 8);
  float* de_s = p_s + kIsingTable;
  int8_t* lat = reinterpret_cast<int8_t*>(smem + kIsingHeader);

  const int slot = blockIdx.x;
  const int LL = L * L;
  const int8_t* src = spins_in + static_cast<size_t>(slot) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) lat[i] = src[i];
  if (threadIdx.x < kIsingTable) {
    p_s[threadIdx.x] = p_tab[slot * kIsingTable + threadIdx.x];
    de_s[threadIdx.x] = de_tab[threadIdx.x];
  }
  __syncthreads();

  const float* u_slot = u + static_cast<size_t>(slot) * 2 * LL;
  float de_total = 0.0f;
  int nacc = 0;
  for (int c = 0; c < 2; ++c) {
    const float* u_c = u_slot + static_cast<size_t>(c) * LL;
    float part = 0.0f;
    for (int idx = threadIdx.x; idx < LL / 2; idx += blockDim.x) {
      const lattice::Site st = lattice::colour_site(idx, c, L, L);
      const int nbr = lat[st.up] + lat[st.dn] + lat[st.lf] + lat[st.rt];
      const int sv = lat[st.site];
      const int k = (sv > 0 ? 5 : 0) + ((nbr + 4) >> 1);
      if (u_c[st.site] < p_s[k]) {
        lat[st.site] = static_cast<int8_t>(-sv);
        part += de_s[k];
        ++nacc;
      }
    }
    // the reduction's barriers also end this colour before the next reads it
    de_total = de_total + block_reduce::sum<kWarps>(part, fred);
  }
  const int nacc_total = block_reduce::sum<kWarps>(nacc, ired);

  int8_t* dst = spins_out + static_cast<size_t>(slot) * LL;
  for (int i = threadIdx.x; i < LL; i += blockDim.x) dst[i] = lat[i];
  if (threadIdx.x == 0) {
    de_out[slot] = de_total;
    nacc_out[slot] = nacc_total;
  }
}

__global__ void __launch_bounds__(kThreads)
potts_sweep_kernel(const int8_t* __restrict__ states_in,
                   int8_t* __restrict__ states_out,
                   const float* __restrict__ u, float* __restrict__ de_out,
                   int32_t* __restrict__ nacc_out, const float* __restrict__ p_tab,
                   const float* __restrict__ de_tab, int H, int W, int q) {
  extern __shared__ unsigned char smem[];
  float* fred = reinterpret_cast<float*>(smem);
  int* ired = reinterpret_cast<int*>(smem + kWarps * 4);
  float* p_s = reinterpret_cast<float*>(smem + kWarps * 8);
  float* de_s = p_s + lattice::kPottsTable;
  int8_t* lat = reinterpret_cast<int8_t*>(smem + kPottsHeader);

  const int slot = blockIdx.x;
  const int HW = H * W;
  const int8_t* src = states_in + static_cast<size_t>(slot) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) lat[i] = src[i];
  for (int i = threadIdx.x; i < lattice::kPottsTable; i += blockDim.x) {
    p_s[i] = p_tab[slot * lattice::kPottsTable + i];
    de_s[i] = de_tab[i];
  }
  __syncthreads();

  const float* u_slot = u + static_cast<size_t>(slot) * 4 * HW;
  float de_total = 0.0f;
  int nacc = 0;
  for (int c = 0; c < 2; ++c) {
    const float* u_prop = u_slot + static_cast<size_t>(2 * c) * HW;
    const float* u_acc = u_prop + HW;
    float part = 0.0f;
    for (int idx = threadIdx.x; idx < HW / 2; idx += blockDim.x) {
      const lattice::Site st = lattice::colour_site(idx, c, H, W);
      lattice::potts_trial(lat, st, u_prop[st.site], u_acc[st.site], q, p_s, de_s,
                           part, nacc);
    }
    de_total = de_total + block_reduce::sum<kWarps>(part, fred);
  }
  const int nacc_total = block_reduce::sum<kWarps>(nacc, ired);

  int8_t* dst = states_out + static_cast<size_t>(slot) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) dst[i] = lat[i];
  if (threadIdx.x == 0) {
    de_out[slot] = de_total;
    nacc_out[slot] = nacc_total;
  }
}

template <typename Kernel>
int launch_with_smem(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

long long ising_sweep_smem_bytes(int length) {
  return kIsingHeader + static_cast<long long>(length) * length;
}

long long potts_sweep_smem_bytes(int height, int width) {
  return kPottsHeader + static_cast<long long>(height) * width;
}

// Kernel #1 on `stream`; returns cudaGetLastError() (0 = launched).
int ising_sweep_launch(const void* spins_in, void* spins_out, const void* u,
                       void* de_out, void* nacc_out, const void* p_tab,
                       const void* de_tab, int n_replicas, int length, void* stream) {
  const int smem = static_cast<int>(ising_sweep_smem_bytes(length));
  const int err = launch_with_smem(ising_sweep_kernel, smem);
  if (err != 0) return err;
  ising_sweep_kernel<<<n_replicas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<const float*>(u), static_cast<float*>(de_out),
      static_cast<int32_t*>(nacc_out), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), length);
  return static_cast<int>(cudaGetLastError());
}

// Kernel #4 on `stream`; returns cudaGetLastError() (0 = launched).
int potts_sweep_launch(const void* states_in, void* states_out, const void* u,
                       void* de_out, void* nacc_out, const void* p_tab,
                       const void* de_tab, int n_replicas, int height, int width,
                       int q, void* stream) {
  const int smem = static_cast<int>(potts_sweep_smem_bytes(height, width));
  const int err = launch_with_smem(potts_sweep_kernel, smem);
  if (err != 0) return err;
  potts_sweep_kernel<<<n_replicas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(states_in), static_cast<int8_t*>(states_out),
      static_cast<const float*>(u), static_cast<float*>(de_out),
      static_cast<int32_t*>(nacc_out), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), height, width, q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
