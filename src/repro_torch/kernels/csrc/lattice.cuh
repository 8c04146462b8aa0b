// Checkerboard site indexing and the Potts site update of the kernels that
// visit sites by flat colour index, #1 / #4 (sweep.cu).  colour_site costs
// a runtime division by W/2, four wrap selects and five row*W+col products
// per site, and potts_trial a runtime `% q`: about half of the first fused
// kernels' instructions outside the cipher (PERF.md §6), so kernels A, #5
// and #2p moved to checkerboard.cuh, whose walk carries the row and column
// and whose halo needs no wrap.  #1 / #4 read their uniforms from device
// memory and sit at half of their byte bound with this indexing.
#pragma once
#include <cstdint>

namespace lattice {

// The idx-th site of colour c on an H x W torus (W even): its flat index and
// its four neighbours.  A row holds W/2 sites of each colour.
struct Site {
  int site, up, dn, lf, rt;
};

__device__ __forceinline__ Site colour_site(int idx, int c, int H, int W) {
  const int half = W / 2;
  const int i = idx / half;
  const int j = 2 * (idx - i * half) + ((i + c) & 1);
  Site s;
  s.site = i * W + j;
  s.up = (i == 0 ? H - 1 : i - 1) * W + j;
  s.dn = (i == H - 1 ? 0 : i + 1) * W + j;
  s.lf = i * W + (j == 0 ? W - 1 : j - 1);
  s.rt = i * W + (j == W - 1 ? 0 : j + 1);
  return s;
}

// Number of Potts ΔE table entries: each of the four direction terms
// [s == nbr] - [trial == nbr] is -1, 0 or +1.
constexpr int kPottsTable = 81;

// One Metropolis/Glauber trial of a Potts site with uniforms (u_prop, u_acc).
// The proposal is the plain version's: d = 1 + floor(u_prop * (q-1)),
// trial = (s + d) % q.  The entry of the (up, down, left, right) term
// tuple selects ΔE and the acceptance probability from tables the wrapper
// built with the plain version's own ops.  Updates lat, part and nacc.
__device__ __forceinline__ void potts_trial(int8_t* lat, const Site& st, float u_prop,
                                            float u_acc, int q, const float* p_s,
                                            const float* de_s, float& part, int& nacc) {
  const int s = lat[st.site];
  const int d = 1 + static_cast<int>(floorf(u_prop * static_cast<float>(q - 1)));
  const int trial = (s + d) % q;
  const int n_up = lat[st.up], n_dn = lat[st.dn], n_lf = lat[st.lf], n_rt = lat[st.rt];
  const int k = 27 * (1 + (s == n_up) - (trial == n_up)) +
                9 * (1 + (s == n_dn) - (trial == n_dn)) +
                3 * (1 + (s == n_lf) - (trial == n_lf)) +
                (1 + (s == n_rt) - (trial == n_rt));
  if (u_acc < p_s[k]) {
    lat[st.site] = static_cast<int8_t>(trial);
    part += de_s[k];
    ++nacc;
  }
}

}  // namespace lattice
