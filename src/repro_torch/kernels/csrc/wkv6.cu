// Kernel #7: the RWKV-6 ("Finch") recurrence, one batch*head slab a block.
//
// Replaces (TPU, Pallas):
//   repro/kernels/wkv6.py::wkv6_pallas (_wkv6_kernel).
// Contract: repro/kernels/ref.py::wkv6 (plain twin: repro_torch.kernels.ref.wkv6).
//
// Per slab, with state S of shape (dk, dv) and any T >= 1:
//   o_t = r_t · S_{t-1} + (Σ_i r_t[i] u[i] k_t[i]) v_t
//   S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
// starting from initial_state (or zeros) and writing S_T.
//
// Bound.  Per slab and step it reads 3dk + dv floats and writes dv; S is
// read and written once.  At the prefill shape (BH = 256, T = 512, dk = dv
// = 64) that is 172 MB, 0.0514 ms at 3.35 TB/s; the update costs 3 FP32
// instructions per state element and step (an FFMA for the output, an FMUL
// and an FFMA for the state), 1.61e9 lane instructions, 0.048 ms at the
// 128-lane issue rate: bytes bound it, by a little.
//
// The first version (one 64-thread block per slab, thread j owning column
// j, synchronous staging, each staged step's bonus a 64-term loop in one
// thread) ran 0.311 ms at prefill, 6x the bound.  What holds a slab back is
// not the serial chain over T (two dependent FP32 operations a step) but
// the operands: a thread holding a rows x b columns of S reads 3a + b
// staged floats a step for 3ab FP32 instructions, and a 128-bit shared
// load costs four wavefronts.  At a = 64, b = 1 (the first version) or
// a = 16, b = 1 with 256 threads (0.241 ms) the SM's shared memory pipe,
// not its FP32 issue, is full (times: wkv6_probe.py, on an H100 80GB HBM3
// at 700 W).
//
// Design.  The TPU kernel walks a (BH, T/chunk) grid whose minor dimension
// runs in order and keeps S in VMEM scratch between chunks.  Blocks here run
// in no order, so the time loop lives inside the block:
// * 64 threads a slab, each holding kRows = 16 rows of kCols = 4 columns
//   of S in registers: thread (g, ct) has rows 4(4m + g) + e (m, e < 4) of
//   columns 4ct .. 4ct + 3, so a quarter warp's LDS.128 of a staged row
//   reads 64 contiguous bytes.  Tiles of 4x4 to 8x8 ran 0.135-0.163 ms,
//   16x4 0.127 ms (PERF.md §6); columns are independent, rows meet only in
//   the output.
// * Per step a thread does its 64 elements' output FFMAs (each column's
//   rows in order), its rows' share of the bonus Σ r·u·k, and the state
//   updates; the four row groups' partial outputs (bonus included) meet by
//   a transposed butterfly of __shfl_xor steps in a fixed order, so the
//   result does not depend on the launch: a split of T into two launches
//   gives the same bits as one.
// * Steps run two at a time (unrolled), so one step's shuffles overlap the
//   next step's rows; the state's update is the only chain between steps.
// * Staging: TC = 32 steps of r, k, w, v (contiguous (TC, d) rows of the
//   slab) are copied by cp.async into one of two shared-memory stages while
//   the other stage's steps run: 16-byte copies where dk (dv) is a multiple
//   of 4 and the rows are 16-byte aligned (one flat copy at d = 64), 4-byte
//   copies otherwise.  64 KB of stages: two slabs an SM (256 on 132 SMs);
//   at TC = 64 one slab an SM fits and a launch takes twice as long.
// * What is left: ~270 instructions a step and thread (192 for the state
//   and output, 36 for the bonus, the rest loads, shuffles and the store)
//   at one warp per scheduler, which issues about every other cycle: 0.127
//   ms, 0.40 of the byte bound, on an H100 80GB HBM3 at 700 W.
//
// Padding.  S always has 64 rows and columns across the block.  Rows i >= dk
// start at zero and see r = k = 0, w = 1 forever (the stages' pad columns,
// written once), so they stay zero and add nothing; columns j >= dv see
// v = 0 and are never written out.  The JAX wrapper pads T to a multiple of
// its chunk with w = 1, k = 0 steps, which leave the state unchanged; this
// kernel needs no padding in T: the last stage simply runs fewer steps.
//
// Numerics.  f32 throughout, nvcc's default contraction of a*b+c into FMA;
// summation order differs from the plain version, so results agree within
// a few ulps of the terms' magnitude, not bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMax = 64;   // largest dk and dv
constexpr int kRows = 16;  // rows of S a thread holds (a multiple of 4)
constexpr int kCols = 4;   // columns of S a thread holds (1, 2, 4 or 8)
constexpr int kThreads = kMax * kMax / (kRows * kCols);  // threads a slab
constexpr int kGroups = kMax / kRows;  // row groups: the lanes of one output sum
constexpr int kQuads = kRows / 4;
constexpr int kTc = 32;  // steps a stage
static_assert(kRows % 4 == 0 && kThreads % 32 == 0 && kGroups <= 32 && kCols <= kGroups &&
                  (kCols & (kCols - 1)) == 0 && (kGroups & (kGroups - 1)) == 0,
              "a tile of whole row quads, power-of-two groups within a warp");

struct Stage {
  float r[kTc][kMax], k[kTc][kMax], w[kTc][kMax], v[kTc][kMax];
};
struct Smem {
  Stage stage[2];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Copies n rows of d floats (contiguous from src) into rows 0..n-1 of dst.
__device__ __forceinline__ void stage_rows(float (*dst)[kMax], const float* src, int n, int d,
                                           bool vec) {
  if (vec && d == kMax) {  // rows as wide as the stage's: one flat copy, no division
    for (int e = threadIdx.x; e < n * kMax / 4; e += kThreads) cp_async16(&dst[0][0] + 4 * e, src + 4 * e);
  } else if (vec) {
    const int quads = d / 4;
    for (int e = threadIdx.x; e < n * quads; e += kThreads) {
      const int tt = e / quads, q = e - tt * quads;
      cp_async16(&dst[tt][4 * q], src + 4 * e);
    }
  } else {
    for (int e = threadIdx.x; e < n * d; e += kThreads) {
      const int tt = e / d, i = e - tt * d;
      cp_async4(&dst[tt][i], src + e);
    }
  }
}

// Row e of quad m of row group g: quads of consecutive groups are adjacent,
// so a quarter warp's LDS.128 of a staged row reads 128 contiguous bytes.
__device__ __forceinline__ int row_of(int g, int m, int e) { return 4 * (kGroups * m + g) + e; }

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int t_len, int dk,
            int dv, bool vec_k, bool vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  // thread (g, ct): rows row_of(g, m, e) of columns kCols*ct .. +kCols-1
  const int g = threadIdx.x % kGroups, j0 = threadIdx.x / kGroups * kCols;
  const long long slab = blockIdx.x;
  const float* r_b = r + slab * t_len * dk;
  const float* k_b = k + slab * t_len * dk;
  const float* w_b = w + slab * t_len * dk;
  const float* v_b = v + slab * t_len * dv;
  float* o_b = o + slab * t_len * dv;

  // stage 0 in flight first; the pad columns (never copied into) are set once
  stage_rows(sm.stage[0].r, r_b, min(kTc, t_len), dk, vec_k);
  stage_rows(sm.stage[0].k, k_b, min(kTc, t_len), dk, vec_k);
  stage_rows(sm.stage[0].w, w_b, min(kTc, t_len), dk, vec_k);
  stage_rows(sm.stage[0].v, v_b, min(kTc, t_len), dv, vec_v);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int e = threadIdx.x; (dk < kMax || dv < kMax) && e < 2 * kTc * kMax; e += kThreads) {
    Stage& st = sm.stage[e / (kTc * kMax)];
    const int tt = (e / kMax) % kTc, i = e % kMax;
    if (i >= dk) {
      st.r[tt][i] = 0.0f;
      st.k[tt][i] = 0.0f;
      st.w[tt][i] = 1.0f;
    }
    if (i >= dv) st.v[tt][i] = 0.0f;
  }

  float s[kRows][kCols], uu[kRows];
#pragma unroll
  for (int m = 0; m < kQuads; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row_of(g, m, e);
      uu[4 * m + e] = i < dk ? u[slab * dk + i] : 0.0f;
#pragma unroll
      for (int f = 0; f < kCols; ++f) {
        const int j = j0 + f;
        s[4 * m + e][f] =
            (s0 != nullptr && i < dk && j < dv) ? s0[(slab * dk + i) * dv + j] : 0.0f;
      }
    }
  }

  // after the output's reduction a lane holds column j0 + col of the sum
  // (the transposed butterfly below), written by the lanes with g < kCols
  int col = 0;
#pragma unroll
  for (int b = 1, half = kCols / 2; b < kCols; b <<= 1, half >>= 1) {
    if (g & b) col += half;
  }

  for (int t0 = 0, c = 0; t0 < t_len; t0 += kTc, ++c) {
    const int n = min(kTc, t_len - t0);
    const Stage& cur = sm.stage[c & 1];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // stage c has landed for every thread, and every thread is done with
    // stage c-1's buffer
    __syncthreads();
    if (t0 + kTc < t_len) {
      Stage& nxt = sm.stage[(c + 1) & 1];
      const int n1 = min(kTc, t_len - t0 - kTc);
      const long long at = static_cast<long long>(t0 + kTc);
      stage_rows(nxt.r, r_b + at * dk, n1, dk, vec_k);
      stage_rows(nxt.k, k_b + at * dk, n1, dk, vec_k);
      stage_rows(nxt.w, w_b + at * dk, n1, dk, vec_k);
      stage_rows(nxt.v, v_b + at * dv, n1, dv, vec_v);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    // two steps at a time: one step's reduction overlaps the next's rows
#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      float rr[kRows], kk[kRows], ww[kRows], vv[kCols];
#pragma unroll
      for (int m = 0; m < kQuads; ++m) {
        const int i = row_of(g, m, 0);
        *reinterpret_cast<float4*>(&rr[4 * m]) = *reinterpret_cast<const float4*>(&cur.r[tt][i]);
        *reinterpret_cast<float4*>(&kk[4 * m]) = *reinterpret_cast<const float4*>(&cur.k[tt][i]);
        *reinterpret_cast<float4*>(&ww[4 * m]) = *reinterpret_cast<const float4*>(&cur.w[tt][i]);
      }
      if constexpr (kCols % 4 == 0) {
#pragma unroll
        for (int f = 0; f < kCols; f += 4) {
          *reinterpret_cast<float4*>(&vv[f]) = *reinterpret_cast<const float4*>(&cur.v[tt][j0 + f]);
        }
      } else {
#pragma unroll
        for (int f = 0; f < kCols; ++f) vv[f] = cur.v[tt][j0 + f];
      }
      // the row group's part of the output and of the bonus Σ r·u·k, its
      // rows in order, then the state
      float bonus = rr[0] * uu[0] * kk[0];
#pragma unroll
      for (int i = 1; i < kRows; ++i) bonus += rr[i] * uu[i] * kk[i];
      float acc[kCols];
#pragma unroll
      for (int f = 0; f < kCols; ++f) {
        acc[f] = rr[0] * s[0][f];
#pragma unroll
        for (int i = 1; i < kRows; ++i) acc[f] += rr[i] * s[i][f];
        acc[f] += bonus * vv[f];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int f = 0; f < kCols; ++f) s[i][f] = ww[i] * s[i][f] + kk[i] * vv[f];
      }
      // the row groups' partials meet in a fixed order: while a lane holds
      // several columns it keeps half and sends half to its partner (a
      // transposed butterfly), then whole butterfly steps; lanes that end
      // with the same column add the same two values
#pragma unroll
      for (int b = 1, width = kCols; b < kGroups; b <<= 1) {
        if (width > 1) {
          width /= 2;
          const bool upper = (g & b) != 0;
#pragma unroll
          for (int f = 0; f < width; ++f) {
            const float keep = upper ? acc[f + width] : acc[f];
            const float send = upper ? acc[f] : acc[f + width];
            acc[f] = keep + __shfl_xor_sync(0xffffffffu, send, b);
          }
        } else {
          acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], b);
        }
      }
      const int j = j0 + col;
      if (g < kCols && j < dv) {
        o_b[static_cast<long long>(t0 + tt) * dv + j] = acc[0];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kQuads; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row_of(g, m, e);
#pragma unroll
      for (int f = 0; f < kCols; ++f) {
        const int j = j0 + f;
        if (i < dk && j < dv) s_out[(slab * dk + i) * dv + j] = s[4 * m + e][f];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Largest dk and dv the kernel takes.
int wkv6_max_dim() { return kMax; }

// Launches kernel #7 on `stream`: one block per slab of r, k, w (bh, t, dk),
// v (bh, t, dv), u (bh, dk), s0 (bh, dk, dv) or null (zeros) -> o (bh, t,
// dv), s_out (bh, dk, dv).  Returns a cudaError_t (0 = launched).
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* o, void* s_out, int bh,
                int t_len, int dk, int dv, void* stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_k = dk % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(w);
  const bool vec_v = dv % 4 == 0 && aligned16(v);
  wkv6_kernel<<<bh, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), t_len, dk, dv, vec_k, vec_v);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
