// serial_chain: the serial Metropolis chains of the HP lattice protein and of
// the Ising model's single_flip update, one chain per replica.
//
// Replaces no Pallas kernel.  In the JAX package both are lax.fori_loop
// chains that XLA compiles into one device loop each:
//   hp_moves_kernel     repro/core/hp.py::HPChain.mcmc_step (loop at :154),
//                       N end/corner moves of one chain per replica;
//   single_flip_kernel  repro/core/ising.py::IsingSystem._single_flip_steps
//                       (loop at :184, vmapped at :208), flips_per_step
//                       single-spin flips of one lattice per replica.
// Each iteration draws its keys with jax.random (HP: split(key, 4), two
// randints, one uniform; single_flip: split(key, 3), randint((2,)), one
// uniform).  These kernels draw the same words from csrc/jax_random.cuh,
// replica r starting from fold_in(fold_in(key, 2t), offset + r) as the JAX
// engine's per-sweep step keys its vmap (offset is a replica shard's first
// global slot, 0 on one device); t is read through a device pointer.  Their
// plain versions are repro_torch/kernels/serial_chain.py (*_plain).
//
// Acceptance.  Each chain's ΔE takes few values: HP -eps*k for the contact
// change k in [-3, 3] (a site has 4 lattice neighbours, one or two of them
// bonded), single_flip 2s(J*nbr - B) for s = ±1 and nbr in {-4,..,4}.  The
// wrapper builds a per-replica table of p and one of ΔE with the plain
// version's own torch expressions, so a kernel compares u < p with the
// plain version's p and adds its ΔE: spins, positions, ΔE sums and counts
// are the plain version's bit for bit.  Draws the result does not need
// (the end move's direction of an interior monomer, the uniform of a move
// that cannot be accepted) are skipped: the key chain does not depend on
// them.
//
// Bound.  Each move or flip is a chain of dependent Threefry-2x32-20 blocks
// (72 32-bit instructions each): HP 6 a move, 5 more for an end move and 2
// more with the contact loop over N for a move that is tested; single_flip
// 10 a flip.  At R=1500 and Hopper's issue rate (33.5e12/s) that work is
// microseconds, but one chain is one thread: 1500 threads are ~11 a
// streaming multiprocessor, so the time is the latency of one chain's
// dependent instructions (~4 cycles each), not the issue rate.  A simple
// kernel first; the latency floor is written down in PERF.md.
//
// Design.  hp_moves_kernel: one thread a replica (64 a block), the chain in
// the output buffer (N*8 bytes, L1-resident), one pass over N for the
// occupancy test and both contact counts.  single_flip_kernel: one block a
// replica; its threads copy the lattice to the output, then thread 0 runs
// the flips there (global memory, L1/L2-cached: 1500 blocks are resident at
// once, where a lattice in shared memory would cut residency to two blocks
// an SM at L=300).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, see
// repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "jax_random.cuh"

namespace {

constexpr int kHpThreads = 64;
constexpr int kFlipThreads = 128;
constexpr int kHpTable = 7;     // contact change k + 3, k in [-3, 3]
constexpr int kFlipTable = 10;  // [s = -1, +1] x [nbr = -4, -2, 0, 2, 4]

__global__ void __launch_bounds__(kHpThreads)
hp_moves_kernel(const int* __restrict__ pos_in, int* __restrict__ pos_out,
                const uint8_t* __restrict__ hmask, const int64_t* __restrict__ key_words,
                const int64_t* __restrict__ t, const float* __restrict__ p_tab,
                const float* __restrict__ de_tab, float* __restrict__ de_out,
                int* __restrict__ nacc_out, int n_replicas, int n, int n_moves,
                unsigned int offset) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_replicas) return;
  const int* src = pos_in + static_cast<size_t>(r) * n * 2;
  int* p = pos_out + static_cast<size_t>(r) * n * 2;
  for (int q = 0; q < 2 * n; ++q) p[q] = src[q];
  const float* prow = p_tab + static_cast<size_t>(r) * kHpTable;
  const int dx[4] = {1, -1, 0, 0};
  const int dy[4] = {0, 0, 1, -1};
  jax_random::Key key = jax_random::replica_key(key_words, t,
                                                  static_cast<uint32_t>(r) + offset);
  float de_acc = 0.0f;
  int nacc = 0;
  for (int m = 0; m < n_moves; ++m) {
    // key, k_site, k_dir, k_u = split(key, 4)
    const jax_random::Key k_step = key;
    key = jax_random::split_at(k_step, 0);
    const int i = jax_random::randint(
        jax_random::randint_keys(jax_random::split_at(k_step, 1)), 0, 0, n);
    const int xi = p[2 * i], yi = p[2 * i + 1];
    int cx, cy;
    if (i == 0 || i == n - 1) {
      // end move: a uniform neighbour of the terminal's chain neighbour
      const int anchor = (i == 0) ? 1 : n - 2;
      const int d = jax_random::randint(
          jax_random::randint_keys(jax_random::split_at(k_step, 2)), 0, 0, 4);
      cx = p[2 * anchor] + dx[d];
      cy = p[2 * anchor + 1] + dy[d];
    } else {
      // corner move: the opposite corner, if i-1 and i+1 span a right angle
      const int ax = p[2 * (i - 1)], ay = p[2 * (i - 1) + 1];
      const int bx = p[2 * (i + 1)], by = p[2 * (i + 1) + 1];
      if (ax == bx || ay == by) continue;
      cx = ax + bx - xi;
      cy = ay + by - yi;
    }
    if (cx == xi && cy == yi) continue;
    bool occupied = false;
    int c_new = 0, c_old = 0;
    const bool h_i = hmask[i] != 0;
    for (int j = 0; j < n; ++j) {
      const int xj = p[2 * j], yj = p[2 * j + 1];
      occupied |= (j != i) && xj == cx && yj == cy;
      if (h_i && hmask[j] != 0 && (j - i > 1 || i - j > 1)) {
        c_new += abs(xj - cx) + abs(yj - cy) == 1;
        c_old += abs(xj - xi) + abs(yj - yi) == 1;
      }
    }
    if (occupied) continue;
    const int k = c_new - c_old + 3;
    if (jax_random::uniform(jax_random::split_at(k_step, 3), 0) < prow[k]) {
      p[2 * i] = cx;
      p[2 * i + 1] = cy;
      de_acc += de_tab[k];
      ++nacc;
    }
  }
  de_out[r] = de_acc;
  nacc_out[r] = nacc;
}

__global__ void __launch_bounds__(kFlipThreads)
single_flip_kernel(const int8_t* __restrict__ spins_in, int8_t* __restrict__ spins_out,
                   const int64_t* __restrict__ key_words, const int64_t* __restrict__ t,
                   const float* __restrict__ p_tab, const float* __restrict__ de_tab,
                   float* __restrict__ de_out, int* __restrict__ nacc_out, int length,
                   int flips, unsigned int offset) {
  const int r = blockIdx.x;
  const size_t cells = static_cast<size_t>(length) * length;
  const int8_t* src = spins_in + r * cells;
  int8_t* s = spins_out + r * cells;
  if (cells % 4 == 0) {  // each lattice starts 4-byte aligned
    const uint32_t* src4 = reinterpret_cast<const uint32_t*>(src);
    uint32_t* dst4 = reinterpret_cast<uint32_t*>(s);
    for (size_t q = threadIdx.x; q < cells / 4; q += blockDim.x) dst4[q] = src4[q];
  } else {
    for (size_t q = threadIdx.x; q < cells; q += blockDim.x) s[q] = src[q];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float* prow = p_tab + static_cast<size_t>(r) * kFlipTable;
  jax_random::Key key = jax_random::replica_key(key_words, t,
                                                  static_cast<uint32_t>(r) + offset);
  float de_acc = 0.0f;
  int nacc = 0;
  for (int f = 0; f < flips; ++f) {
    // key, k_site, k_u = split(key, 3); (row, col) = randint(k_site, (2,), 0, L)
    const jax_random::Key k_step = key;
    key = jax_random::split_at(k_step, 0);
    const jax_random::RandintKeys ks =
        jax_random::randint_keys(jax_random::split_at(k_step, 1));
    const int row = jax_random::randint(ks, 0, 0, length);
    const int col = jax_random::randint(ks, 1, 0, length);
    const int up = (row + 1 == length ? 0 : row + 1) * length;
    const int down = (row == 0 ? length - 1 : row - 1) * length;
    const int here = row * length;
    const int right = col + 1 == length ? 0 : col + 1;
    const int left = col == 0 ? length - 1 : col - 1;
    const int sv = s[here + col];
    const int nbr = s[up + col] + s[down + col] + s[here + right] + s[here + left];
    const int k = (sv > 0 ? 5 : 0) + (nbr + 4) / 2;
    if (jax_random::uniform(jax_random::split_at(k_step, 2), 0) < prow[k]) {
      s[here + col] = static_cast<int8_t>(-sv);
      de_acc += de_tab[k];
      ++nacc;
    }
  }
  de_out[r] = de_acc;
  nacc_out[r] = nacc;
}

}  // namespace

extern "C" {

// Launches on `stream`: pos (R, N, 2) int32 in and out, hmask (N,) uint8,
// p_tab (R, 7) and de_tab (7,) f32, de (R,) f32, nacc (R,) int32; replica r
// keyed as global slot offset + r; returns cudaGetLastError().
int hp_moves_launch(const void* pos_in, void* pos_out, const void* hmask,
                    const void* key_words, const void* t, const void* p_tab,
                    const void* de_tab, void* de, void* nacc, int n_replicas, int n,
                    int n_moves, unsigned int offset, void* stream) {
  const int blocks = (n_replicas + kHpThreads - 1) / kHpThreads;
  hp_moves_kernel<<<blocks, kHpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos_in), static_cast<int*>(pos_out),
      static_cast<const uint8_t*>(hmask), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<float*>(de), static_cast<int*>(nacc),
      n_replicas, n, n_moves, offset);
  return static_cast<int>(cudaGetLastError());
}

// Launches on `stream`: spins (R, L, L) int8 in and out, p_tab (R, 2, 5) and
// de_tab (2, 5) f32, de (R,) f32, nacc (R,) int32; replica r keyed as global
// slot offset + r; returns cudaGetLastError().
int single_flip_launch(const void* spins_in, void* spins_out, const void* key_words,
                       const void* t, const void* p_tab, const void* de_tab, void* de,
                       void* nacc, int n_replicas, int length, int flips,
                       unsigned int offset, void* stream) {
  single_flip_kernel<<<n_replicas, kFlipThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(spins_in), static_cast<int8_t*>(spins_out),
      static_cast<const int64_t*>(key_words), static_cast<const int64_t*>(t),
      static_cast<const float*>(p_tab), static_cast<const float*>(de_tab),
      static_cast<float*>(de), static_cast<int*>(nacc), length, flips, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
