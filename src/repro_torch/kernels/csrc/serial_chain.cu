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
// that cannot be accepted) are made all the same: the key chain does not
// depend on them.
//
// Bound.  Only the key chain is serial whatever the design: step m+1's key
// is fold_in(step m's key, 0), one Threefry block; the site, direction and
// uniform of a step hang off its key and never depend on the state.  So a
// chain's floor is one block's dependent instructions a step (~0.1 µs)
// beside the data-dependent update.  At R=1500 single_flip also reads and
// writes 135 MB of lattice (0.081 ms at 3.35 TB/s), which sets its pace;
// HP moves 0.5 MB and is latency-bound.
//
// Design.  Both kernels walk the key chain once, draw every other word on
// the other lanes in parallel, and leave the moves in order on the serial
// path with only the state update there.
//   hp_moves_kernel: one warp a replica, kHpWarps warps a block (fewer when
//   N is too long for the chains in shared memory).  The chain (N int2)
//   lives in shared memory, lane l scanning monomers l, l+32, ...; a chain
//   too long for one warp's shared memory (N over ~25,800) lives in the
//   output rows instead.  For a tile of up to 32 moves every lane walks the
//   keys in lockstep and lane m keeps move m's key, then draws its site,
//   direction and uniform (9 blocks, on 32 lanes at once).  Each move then
//   runs warp-wide: the draws come by __shfl_sync, the occupancy by
//   __any_sync, the contact counts by __reduce_add_sync, and lane 0 writes
//   an accepted position.
//   single_flip_kernel: one block of 3 warps a replica, so that 1500 blocks
//   are resident at once (12 an SM, 56 registers a thread).  The lattice
//   stays in global memory: at L=300 it is 90 KB, which in shared memory
//   would cut residency to two blocks an SM.  Tiles of kFlipTile flips go
//   through a pipeline with one __syncthreads a stage: in stage s warp 0's
//   lane 0 walks tile s+1's keys, warp 2 draws tile s (row, col and u, 9
//   blocks a flip) and warp 1 applies tile s-1.  In stage 0 all three warps
//   copy the lattice in 2 KB chunks handed out by a shared counter: warp 1
//   at once, warp 0 after walking tiles 0 and 1, warp 2 after drawing tile
//   0 (named barrier 2 hands it the keys).  A draw is the flat site and a
//   word of 10 acceptance bits u < p[k] and the site's 4 wrap flags; warp 2
//   also links each of the flip's 5 sites to the latest earlier flip of
//   the tile at that site, through a table of the tile's sites in shared
//   memory (a flip mask a site).  Warp 1 reads the spins of the unlinked
//   sites from the output lattice (the tile's start), then lane 0 applies
//   the flips from shared memory alone: a linked site's spin is its
//   flip's result, so a flip sees every earlier one (at L=5 every flip
//   collides).  Reading the five spins from the lattice in the serial pass
//   instead is exact too, but there, with 1500 blocks at once, each read
//   waits ~1,300 cycles, and the kernel takes 1.3x as long at L=300.
//   k = 5 (s > 0) + (nbr + 4) / 2 comes from two byte dot
//   products, the flip is bit k of the word, and an accepted one is written
//   to the lattice at once.  ΔE is summed in flip order after each tile
//   from the k each flip recorded (a rejected flip adds 0.0f, as the plain
//   version's where(accept, de, 0) does).
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, see
// repro_torch/kernels/build.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "jax_random.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // Hopper: the most a block can opt in to
constexpr int kHpWarps = 4;       // replicas (a warp each) a block
constexpr int kHpTable = 7;       // contact change k + 3, k in [-3, 3]
constexpr int kFlipThreads = 96;  // warp 0 walks, warp 1 flips, warp 2 draws
constexpr int kDrawThreads = kFlipThreads - 64;
constexpr int kFlipTile = 128;    // flips a pipeline stage
constexpr int kSites = 5;         // a flip reads its site and 4 neighbours
constexpr int kCopyVecs = 128;   // 16-byte vectors a chunk of the lattice copy (2 KB)
constexpr int kHashBits = 8;      // a table of a tile's sites, twice kFlipTile slots
constexpr int kHashSlots = 1 << kHashBits;
constexpr int kFlipTable = 10;    // [s = -1, +1] x [nbr = -4, -2, 0, 2, 4]
constexpr int kFlipReject = kFlipTable;  // the ΔE slot (0.0f) of a rejected flip
// wrap flags of a draw, above its 10 acceptance bits
constexpr unsigned kUpWrap = 1u << 10, kDownWrap = 1u << 11;
constexpr unsigned kRightWrap = 1u << 12, kLeftWrap = 1u << 13;

// Dynamic shared memory of an hp_moves block: the ΔE row and each warp's p
// row (8 floats each), then, where the chains live in shared memory, hmask
// (n bytes, padded to 8) and each warp's chain.
size_t hp_smem_bytes(int n, int warps, bool chains) {
  const size_t tables = sizeof(float) * 8 * (1 + warps);
  return chains ? tables + static_cast<size_t>((n + 7) & ~7) +
                      sizeof(int2) * static_cast<size_t>(n) * warps
                : tables;
}

__global__ void __launch_bounds__(32 * kHpWarps)
hp_moves_kernel(const int* __restrict__ pos_in, int* __restrict__ pos_out,
                const uint8_t* __restrict__ hmask, const int64_t* __restrict__ key_words,
                const int64_t* __restrict__ t, const float* __restrict__ p_tab,
                const float* __restrict__ de_tab, float* __restrict__ de_out,
                int* __restrict__ nacc_out, int n_replicas, int n, int n_moves,
                unsigned int offset, bool smem_chains) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* de_s = reinterpret_cast<float*>(smem);
  float* p_s = de_s + 8 * (1 + warp);
  const int r = blockIdx.x * warps + warp;
  int2* dst = reinterpret_cast<int2*>(pos_out) + static_cast<size_t>(r) * n;
  // the chain and hmask in shared memory, or else the output row and hmask itself
  const uint8_t* h = hmask;
  int2* chain = dst;
  if (smem_chains) {
    uint8_t* h_s = smem + sizeof(float) * 8 * (1 + warps);
    for (int j = threadIdx.x; j < n; j += blockDim.x) h_s[j] = hmask[j] != 0;
    h = h_s;
    chain = reinterpret_cast<int2*>(h_s + ((n + 7) & ~7)) + static_cast<size_t>(warp) * n;
  }
  if (threadIdx.x < kHpTable) de_s[threadIdx.x] = de_tab[threadIdx.x];
  __syncthreads();
  if (r >= n_replicas) return;
  if (lane < kHpTable) p_s[lane] = p_tab[static_cast<size_t>(r) * kHpTable + lane];
  const int2* src = reinterpret_cast<const int2*>(pos_in) + static_cast<size_t>(r) * n;
  for (int j = lane; j < n; j += 32) chain[j] = src[j];
  __syncwarp();
  jax_random::Key key = jax_random::replica_key(key_words, t,
                                                  static_cast<uint32_t>(r) + offset);
  float de_acc = 0.0f;
  int nacc = 0;
  for (int m0 = 0; m0 < n_moves; m0 += 32) {
    const int count = min(32, n_moves - m0);
    // key, k_site, k_dir, k_u = split(key, 4): every lane walks the keys,
    // lane m keeps move m0 + m's
    jax_random::Key mine = key;
    for (int m = 0; m < count; ++m) {
      if (lane == m) mine = key;
      if (m0 + m + 1 < n_moves) key = jax_random::split_at(key, 0);
    }
    const int site = jax_random::randint(
        jax_random::randint_keys(jax_random::split_at(mine, 1)), 0, 0, n);
    const int dir = jax_random::randint(
        jax_random::randint_keys(jax_random::split_at(mine, 2)), 0, 0, 4);
    const float u_mine = jax_random::uniform(jax_random::split_at(mine, 3), 0);
    for (int m = 0; m < count; ++m) {
      const int i = __shfl_sync(kFull, site, m);
      const int2 cur = chain[i];
      int2 cand;
      if (i == 0 || i == n - 1) {
        // end move: a uniform neighbour of the terminal's chain neighbour
        const int d = __shfl_sync(kFull, dir, m);
        const int2 a = chain[i == 0 ? 1 : n - 2];
        cand = make_int2(a.x + (d == 0 ? 1 : d == 1 ? -1 : 0),
                         a.y + (d == 2 ? 1 : d == 3 ? -1 : 0));
      } else {
        // corner move: the opposite corner, if i-1 and i+1 span a right angle
        const int2 a = chain[i - 1], b = chain[i + 1];
        if (a.x == b.x || a.y == b.y) continue;
        cand = make_int2(a.x + b.x - cur.x, a.y + b.y - cur.y);
      }
      if (cand.x == cur.x && cand.y == cur.y) continue;
      const bool h_i = h[i] != 0;
      bool occupied = false;
      int c_new = 0, c_old = 0;
      for (int j = lane; j < n; j += 32) {
        const int2 pj = chain[j];
        occupied |= j != i && pj.x == cand.x && pj.y == cand.y;
        if (h_i && h[j] != 0 && (j - i > 1 || i - j > 1)) {
          c_new += abs(pj.x - cand.x) + abs(pj.y - cand.y) == 1;
          c_old += abs(pj.x - cur.x) + abs(pj.y - cur.y) == 1;
        }
      }
      if (__any_sync(kFull, occupied)) continue;
      const int k = __reduce_add_sync(kFull, c_new) - __reduce_add_sync(kFull, c_old) + 3;
      if (__shfl_sync(kFull, u_mine, m) < p_s[k]) {
        if (lane == 0) chain[i] = cand;
        __syncwarp();
        de_acc += de_s[k];
        ++nacc;
      }
    }
  }
  if (smem_chains)
    for (int j = lane; j < n; j += 32) dst[j] = chain[j];
  if (lane == 0) {
    de_out[r] = de_acc;
    nacc_out[r] = nacc;
  }
}

// dst[0, n) = src[0, n) in chunks of kCopyVecs 16-byte vectors (bytes where
// src and dst do not share their offset modulo 16; the ragged ends as one
// more chunk), handed out by *next: any warp may join, its lanes copying a
// chunk together with every load in flight before the first store.
__device__ void copy_chunks(const int8_t* __restrict__ src, int8_t* __restrict__ dst,
                            size_t n, unsigned* next, int lane) {
  const size_t mis = reinterpret_cast<uintptr_t>(src) & 15;
  const bool vec = mis == (reinterpret_cast<uintptr_t>(dst) & 15);
  const size_t lead = (16 - mis) & 15;
  const size_t head = vec ? (lead < n ? lead : n) : 0;
  const size_t body = vec ? (n - head) / 16 : 0;
  const size_t vec_chunks = (body + kCopyVecs - 1) / kCopyVecs;
  const size_t chunks = vec ? vec_chunks + 1 : (n + 16 * kCopyVecs - 1) / (16 * kCopyVecs);
  for (;;) {
    unsigned c = 0;
    if (lane == 0) c = atomicAdd(next, 1u);
    c = __shfl_sync(kFull, c, 0);
    if (c >= chunks) return;
    if (!vec || c == vec_chunks) {
      const size_t lo = vec ? 0 : c * 16 * kCopyVecs;
      const size_t hi = vec ? head : min(n, lo + 16 * kCopyVecs);
      for (size_t i = lo + lane; i < hi; i += 32) dst[i] = src[i];
      if (vec)
        for (size_t i = head + 16 * body + lane; i < n; i += 32) dst[i] = src[i];
      continue;
    }
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head) + c * kCopyVecs;
    uint4* d4 = reinterpret_cast<uint4*>(dst + head) + c * kCopyVecs;
    const size_t m = min(body - c * kCopyVecs, static_cast<size_t>(kCopyVecs));
    uint4 v[kCopyVecs / 32];
#pragma unroll
    for (int i = 0; i < kCopyVecs / 32; ++i)
      if (lane + 32 * i < m) v[i] = s4[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < kCopyVecs / 32; ++i)
      if (lane + 32 * i < m) d4[lane + 32 * i] = v[i];
  }
}

// Flat index of site q of a flip at flat site c with wrap flags w: its up,
// down, right and left neighbours, then (q = 4) the site itself.
__device__ __forceinline__ int flip_site(int c, unsigned w, int q, int length) {
  const int up_wrap = -(length - 1) * length;  // row L-1's up is row 0
  switch (q) {
    case 0: return c + ((w & kUpWrap) ? up_wrap : length);
    case 1: return c + ((w & kDownWrap) ? -up_wrap : -length);
    case 2: return c + ((w & kRightWrap) ? 1 - length : 1);
    case 3: return c + ((w & kLeftWrap) ? length - 1 : -1);
    default: return c;
  }
}

struct FlipSmem {
  jax_random::Key keys[2][kFlipTile];  // a tile's step keys (walker -> drawers)
  uint2 draw[2][kFlipTile];            // {flat site row * L + col, acceptance bits | wraps}
  uint2 link[2][kFlipTile];            // byte q: the tile's latest earlier flip at site q
  uint2 base[kFlipTile];               // byte q: site q's spin at the tile's start
  int8_t val[kFlipTile];               // a flip's centre spin after it
  uint8_t k[kFlipTile];                // a flip's ΔE slot: k, or kFlipReject
  int site_key[kHashSlots];            // the drawn tile's sites, open addressing (-1: free)
  unsigned site_flips[kHashSlots][kFlipTile / 32];  // the tile's flips at each of them
  float p[kFlipTable];                 // this replica's acceptance row
  float de[kFlipTable + 1];            // ΔE by k, 0.0f at kFlipReject
  unsigned copy_next;                  // the lattice copy's next chunk
};
constexpr unsigned kNoLink = 0xffu;  // a link byte with no earlier flip (and the padding)
static_assert(kFlipTile <= 255 && kFlipTile % 32 == 0 && 2 * kFlipTile <= kHashSlots,
              "a link byte holds a flip of the tile; the site table is at most half full");

__device__ __forceinline__ unsigned site_hash(int c) {
  return (static_cast<unsigned>(c) * 2654435761u) >> (32 - kHashBits);
}

// Clears the site table (the drawers, before a tile's inserts).
__device__ __forceinline__ void clear_sites(FlipSmem& sm, int tid, int threads) {
  for (int i = tid; i < kHashSlots; i += threads) {
    sm.site_key[i] = -1;
#pragma unroll
    for (int w = 0; w < kFlipTile / 32; ++w) sm.site_flips[i][w] = 0u;
  }
}

// Records flip j of the drawn tile at site c.
__device__ __forceinline__ void insert_site(FlipSmem& sm, int c, int j) {
  unsigned h = site_hash(c);
  for (;;) {
    const int prev = atomicCAS(&sm.site_key[h], -1, c);
    if (prev == -1 || prev == c) break;
    h = (h + 1) & (kHashSlots - 1);
  }
  atomicOr(&sm.site_flips[h][j / 32], 1u << (j % 32));
}

// The latest flip before flip j of the drawn tile at site c, or kNoLink.
__device__ __forceinline__ unsigned latest_before(const FlipSmem& sm, int c, int j) {
  unsigned h = site_hash(c);
  for (;;) {
    const int key = sm.site_key[h];
    if (key == c) break;
    if (key == -1) return kNoLink;
    h = (h + 1) & (kHashSlots - 1);
  }
  for (int w = j / 32; w >= 0; --w) {
    unsigned m = sm.site_flips[h][w];
    if (w == j / 32) m &= (1u << (j % 32)) - 1u;
    if (m != 0u) return 32 * w + 31 - __clz(m);
  }
  return kNoLink;
}

__device__ __forceinline__ unsigned byte_of(uint2 x, int q) {
  return ((q < 4 ? x.x : x.y) >> (8 * (q & 3))) & 0xffu;
}

// Tile b's keys from `key` (one thread): key, k_site, k_u = split(key, 3).
__device__ __forceinline__ void walk_tile(FlipSmem& sm, jax_random::Key& key, int b,
                                          int flips) {
  const int f0 = b * kFlipTile, count = min(kFlipTile, flips - f0);
  jax_random::Key* out = sm.keys[b & 1];
  for (int j = 0; j < count; ++j) {
    out[j] = key;
    if (f0 + j + 1 < flips) key = jax_random::split_at(key, 0);
  }
}

// Tile b's draws from its keys, then each flip's links (through the site
// table, which they leave clear), by the kDrawThreads threads of warps 2,
// 3, ... (`tid` this one's rank among them).
__device__ __forceinline__ void draw_tile(FlipSmem& sm, int b, int flips, int length,
                                          int tid) {
  const int count = min(kFlipTile, flips - b * kFlipTile);
  uint2* draw = sm.draw[b & 1];
  for (int j = tid; j < count; j += kDrawThreads) {
    // (row, col) = randint(k_site, (2,), 0, L); u = uniform(k_u)
    const jax_random::Key k = sm.keys[b & 1][j];
    const jax_random::RandintKeys rk = jax_random::randint_keys(jax_random::split_at(k, 1));
    const int row = jax_random::randint(rk, 0, 0, length);
    const int col = jax_random::randint(rk, 1, 0, length);
    const float u = jax_random::uniform(jax_random::split_at(k, 2), 0);
    unsigned w = (row + 1 == length ? kUpWrap : 0u) | (row == 0 ? kDownWrap : 0u) |
                 (col + 1 == length ? kRightWrap : 0u) | (col == 0 ? kLeftWrap : 0u);
#pragma unroll
    for (int q = 0; q < kFlipTable; ++q) w |= (u < sm.p[q] ? 1u : 0u) << q;
    draw[j] = make_uint2(static_cast<unsigned>(row * length + col), w);
    insert_site(sm, row * length + col, j);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kDrawThreads) : "memory");
  for (int j = tid; j < count; j += kDrawThreads) {
    unsigned link[kSites];
#pragma unroll
    for (int q = 0; q < kSites; ++q)
      link[q] = latest_before(
          sm, flip_site(static_cast<int>(draw[j].x), draw[j].y, q, length), j);
    sm.link[b & 1][j] = make_uint2(link[0] | link[1] << 8 | link[2] << 16 | link[3] << 24,
                                   link[4] | 0xffffff00u);  // padding: kNoLink
  }
  asm volatile("bar.sync 1, %0;" ::"n"(kDrawThreads) : "memory");
  clear_sites(sm, tid, kDrawThreads);
}

// Tile a's flips, in order, by warp 1: its lanes read the spins the tile
// reads before any flip of its own writes them, then lane 0 applies the
// flips from shared memory alone and writes each accepted one to `s`.
__device__ __forceinline__ void apply_tile(FlipSmem& sm, int a, int flips, int length,
                                           int lane, int8_t* s, float& de_acc, int& nacc) {
  const int count = min(kFlipTile, flips - a * kFlipTile);
  const uint2* draw = sm.draw[a & 1];
  const uint2* link = sm.link[a & 1];
  for (int f0 = lane; f0 < kFlipTile; f0 += 64) {  // ten loads in flight, then the stores
    int8_t got[2][kSites];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + 32 * i;
#pragma unroll
      for (int q = 0; q < kSites; ++q)
        got[i][q] = f < count && byte_of(link[f], q) == kNoLink
                        ? s[flip_site(static_cast<int>(draw[f].x), draw[f].y, q, length)]
                        : 0;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (f0 + 32 * i < count) {
#pragma unroll
        for (int q = 0; q < kSites; ++q)
          reinterpret_cast<int8_t*>(&sm.base[f0 + 32 * i])[q] = got[i][q];
      }
    }
  }
  __syncwarp();
  if (lane != 0) return;
  uint2 d_next = draw[0], l_next = link[0], b_next = sm.base[0];
  for (int f = 0; f < count; ++f) {
    const uint2 d = d_next, l = l_next, b = b_next;
    if (f + 1 < count) {  // the next record, loaded before this flip's stores
      d_next = draw[f + 1];
      l_next = link[f + 1];
      b_next = sm.base[f + 1];
    }
    // the 4 neighbours' spins in b.x, the site's in b.y's low byte
    unsigned nb = b.x, sw = b.y;
    if ((l.x & l.y) != 0xffffffffu) {  // a site an earlier flip of the tile wrote
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned g = byte_of(l, q);
        if (g != kNoLink)
          nb = (nb & ~(0xffu << (8 * q))) |
               static_cast<unsigned>(static_cast<uint8_t>(sm.val[g])) << (8 * q);
      }
      if (byte_of(l, 4) != kNoLink) sw = static_cast<uint8_t>(sm.val[byte_of(l, 4)]);
    }
    // k = 5 (s > 0) + (nbr + 4) / 2 = (nbr + 5 s + 9) / 2, in two byte dot products
    const int k =
        __dp4a(static_cast<int>(nb), 0x01010101, __dp4a(static_cast<int>(sw), 5, 9)) >> 1;
    const int sv = static_cast<int8_t>(sw);
    const bool accept = (d.y >> k) & 1u;
    sm.val[f] = static_cast<int8_t>(accept ? -sv : sv);
    if (accept) s[d.x] = static_cast<int8_t>(-sv);
    sm.k[f] = static_cast<uint8_t>(accept ? k : kFlipReject);
  }
#pragma unroll 8
  for (int f = 0; f < count; ++f) {  // ΔE in flip order
    const int k = sm.k[f];
    de_acc += sm.de[k];
    nacc += k != kFlipReject;
  }
}

__global__ void __launch_bounds__(kFlipThreads, 12)
single_flip_kernel(const int8_t* __restrict__ spins_in, int8_t* __restrict__ spins_out,
                   const int64_t* __restrict__ key_words, const int64_t* __restrict__ t,
                   const float* __restrict__ p_tab, const float* __restrict__ de_tab,
                   float* __restrict__ de_out, int* __restrict__ nacc_out, int length,
                   int flips, unsigned int offset) {
  __shared__ FlipSmem sm;
  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t cells = static_cast<size_t>(length) * length;
  int8_t* s = spins_out + r * cells;
  if (threadIdx.x < kFlipTable) {
    sm.p[threadIdx.x] = p_tab[static_cast<size_t>(r) * kFlipTable + threadIdx.x];
    sm.de[threadIdx.x] = de_tab[threadIdx.x];
  }
  if (threadIdx.x == kFlipTable) sm.de[kFlipReject] = 0.0f;
  clear_sites(sm, threadIdx.x, kFlipThreads);
  if (threadIdx.x == 0) sm.copy_next = 0u;
  jax_random::Key key{0u, 0u};
  if (threadIdx.x == 0)
    key = jax_random::replica_key(key_words, t, static_cast<uint32_t>(r) + offset);
  __syncthreads();
  float de_acc = 0.0f;
  int nacc = 0;
  const int tiles = (flips + kFlipTile - 1) / kFlipTile;
  // Stage s: warp 0's lane 0 walks tile s+1, warp 2 draws tile s, warp 1
  // applies tile s-1.  In stage 0 warp 1 starts the lattice copy at once,
  // warp 0 joins it after walking tiles 0 and 1 and warp 2 after drawing
  // tile 0 (barrier 2: tile 0's keys are written).
  for (int stage = 0; stage <= tiles; ++stage) {
    if (warp == 0) {
      if (stage == 0 && tiles > 0) {
        if (lane == 0) walk_tile(sm, key, 0, flips);
        __syncwarp();
        __threadfence_block();
        asm volatile("bar.arrive 2, %0;" ::"n"(32 + kDrawThreads) : "memory");
      }
      if (lane == 0 && stage + 1 < tiles) walk_tile(sm, key, stage + 1, flips);
      __syncwarp();
    } else if (warp >= 2 && stage < tiles) {
      if (stage == 0) asm volatile("bar.sync 2, %0;" ::"n"(32 + kDrawThreads) : "memory");
      draw_tile(sm, stage, flips, length, threadIdx.x - 64);
    }
    if (stage == 0) copy_chunks(spins_in + r * cells, s, cells, &sm.copy_next, lane);
    if (warp == 1 && stage >= 1) apply_tile(sm, stage - 1, flips, length, lane, s, de_acc, nacc);
    __syncthreads();
  }
  if (threadIdx.x == 32) {
    de_out[r] = de_acc;
    nacc_out[r] = nacc;
  }
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
  const bool smem_chains = hp_smem_bytes(n, 1, true) <= kMaxSmem;
  int warps = kHpWarps;
  while (smem_chains && hp_smem_bytes(n, warps, true) > kMaxSmem) --warps;
  const size_t smem = hp_smem_bytes(n, warps, smem_chains);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hp_moves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_replicas + warps - 1) / warps;
  hp_moves_kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos_in), static_cast<int*>(pos_out),
      static_cast<const uint8_t*>(hmask), static_cast<const int64_t*>(key_words),
      static_cast<const int64_t*>(t), static_cast<const float*>(p_tab),
      static_cast<const float*>(de_tab), static_cast<float*>(de), static_cast<int*>(nacc),
      n_replicas, n, n_moves, offset, smem_chains);
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
