// The Ising site updates of the fused sweep loop (checkerboard.cuh): one
// replica a byte (kernel A, ising_fused.cu) and kRep replicas a byte, one
// bit each (kernel #2p, ising_packed.cu).
//
// Acceptance.  No expf per site.  The wrapper builds, once per launch and
// with the plain version's own torch ops, the 10-entry rows
//   de_tab[s][n]  = 2*s*(j*nbr - b)            s in {-1,+1}, nbr in {-4..4 step 2}
//   p_tab[r][s][n] = accept_prob(de_tab, betas[r])
// and a block turns its rungs' rows into thresholds (checkerboard.cuh).
// Spins sit in shared memory as 1 (up) and 0 (down), so entry s*5 + n is
// five times the site's spin plus its up neighbours.
#pragma once
#include <cstdint>

#include "checkerboard.cuh"

namespace ising {

// One replica a byte: a site's table entry s_idx*5 + n of the wrapper's rows
// is 5*v plus its four neighbours.
struct Rule {
  const checkerboard::Entry* tab;

  __device__ static uint8_t to_shared(int8_t s) { return s > 0; }
  __device__ static int8_t from_shared(uint8_t v) { return v ? 1 : -1; }

  template <int kN>
  __device__ __forceinline__ void update(const checkerboard::Site (&st)[kN],
                                         const threefry::Schedule& ks, int c,
                                         float& part, int& nacc) const {
    uint32_t e[kN], bits[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      e[s] = 5 * st[s].v + st[s].up + st[s].dn + st[s].lf + st[s].rt;
      bits[s] = threefry::hash(ks, static_cast<uint32_t>(c), st[s].ctr).x0;
    }
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const checkerboard::Entry ent = tab[e[s]];
      if (st[s].live && checkerboard::accept(bits[s], ent.thr)) {
        *st[s].at = static_cast<uint8_t>(1u - st[s].v);
        part += ent.de;
        ++nacc;
      }
    }
  }
};

// Byte offset of entry 5*s + n0 + 2*n1 + 4*n2 in an 8-byte-entry row, from a
// word whose bytes 0-3 hold s, n0, n1, n2 in bit 0 (the rest masked off):
// the product's top byte is their weighted sum (40, 8, 16, 32; no byte of
// the product carries into the next).
constexpr uint32_t kEntryOffset = (40u << 24) | (8u << 16) | (16u << 8) | 32u;

// kRep replicas a byte, bit r for replica r (multispin coding).  Per site
// the up-neighbour count's bit-planes n0, n1, n2 come once for all replicas
// from a bitwise full adder (the JAX kernel's) and sit beside the spins in
// one word; then, replica by replica, the site picks its entry from bit r
// of each byte, hashes, compares and flips bit r.  The byte is written once.
//
// Registers.  The replicas are a loop (not unrolled) outside the run's kN
// sites, so one replica's schedule (loaded from shared memory, made once
// per sweep) and kN hash chains are live at a time, as in kernel A; the
// replicas' partial sums and counts rotate through kRep registers each, so
// every index stays static: partial r of a thread adds the same terms in
// the same order as kernel A's thread does for that replica.  Nothing else
// per site outlives a replica pass but its word: a padding site's word is
// all ones, whose entry (12) has a zero threshold and never accepts, and
// the counters are re-derived from the run's first (site s has ctr + 2s).
template <int kRep>
struct PackedRule {
  static constexpr int kRow = 13;  // entries a replica's row: 10, 2 unused, the padding's
  const checkerboard::Entry* tab;  // kRep rows of kRow

  __device__ static uint8_t to_shared(int8_t s) { return s > 0; }
  __device__ static int8_t from_shared(uint8_t v) { return v ? 1 : -1; }

  template <int kN>
  __device__ __forceinline__ void update(const checkerboard::Site (&st)[kN],
                                         const threefry::Schedule* ks, int c,
                                         float (&part)[kRep], int (&nacc)[kRep]) const {
    uint32_t w[kN];  // byte 0 the spins, bytes 1-3 the planes n0, n1, n2
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const uint32_t s0 = st[s].up ^ st[s].dn, c0 = st[s].up & st[s].dn;
      const uint32_t s1 = st[s].lf ^ st[s].rt, c1 = st[s].lf & st[s].rt;
      const uint32_t n0 = s0 ^ s1, c2 = s0 & s1;
      const uint32_t n1 = c0 ^ c1 ^ c2;
      const uint32_t n2 = (c0 & c1) | (c0 & c2) | (c1 & c2);
      w[s] = st[s].live ? st[s].v | n0 << 8 | n1 << 16 | n2 << 24 : 0xFFFFFFFFu;
    }
    const char* row = reinterpret_cast<const char*>(tab);
    const uint4* sched = reinterpret_cast<const uint4*>(ks);
    uint32_t ctr = st[0].ctr;
#pragma unroll 1
    for (int r = 0; r < kRep; ++r) {
      asm volatile("" : "+r"(ctr));  // re-derive the kN counters each pass
      const uint4 a = sched[2 * r], b = sched[2 * r + 1];
      const threefry::Schedule k = {{a.x, a.y, a.z}, {a.w, b.x, b.y, b.z, b.w}};
      uint32_t ctrs[kN], bits[kN];
#pragma unroll
      for (int s = 0; s < kN; ++s) ctrs[s] = ctr + 2 * s;
      threefry::hash_x0<kN>(k, static_cast<uint32_t>(c), ctrs, bits);
      float p = part[0];
      int n = nacc[0];
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const uint32_t off = (((w[s] >> r) & 0x01010101u) * kEntryOffset) >> 24;
        const checkerboard::Entry ent = *reinterpret_cast<const checkerboard::Entry*>(row + off);
        if (checkerboard::accept(bits[s], ent.thr)) {
          w[s] ^= 1u << r;
          p += ent.de;
          ++n;
        }
      }
      // rotate: after kRep replicas every partial is back in its register
#pragma unroll
      for (int q = 0; q + 1 < kRep; ++q) {
        part[q] = part[q + 1];
        nacc[q] = nacc[q + 1];
      }
      part[kRep - 1] = p;
      nacc[kRep - 1] = n;
      row += kRow * sizeof(checkerboard::Entry);
    }
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      if (st[s].live) *st[s].at = static_cast<uint8_t>(w[s]);
    }
  }
};

}  // namespace ising
