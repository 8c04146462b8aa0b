// Kernel #7b: the gradient of the RWKV-6 ("Finch") recurrence, one launch.
//
// Replaces: no TPU kernel.  The JAX package trains through XLA's autodiff
// of repro/kernels/ref.py::wkv6 (its lax.scan); this is that gradient on
// the card, for the forward that kernel #7 (wkv6.cu) computes.
// Plain twin: the gradient of repro_torch.kernels.ref.wkv6 under autograd.
//
// Per slab, with S_{-1} = s0 (or zeros) and t = 0 .. T-1:
//   o_t = r_t · S_{t-1} + (r_t · (u ⊙ k_t)) v_t
//   S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
// Given do (BH, T, dv) and dS_{T-1} = d(final state) (or zeros), walking t
// down from T-1, with dS_t the gradient with respect to S_t:
//   dr_t = S_{t-1} · do_t + (u ⊙ k_t)(v_t · do_t)
//   dk_t = dS_t · v_t + (u ⊙ r_t)(v_t · do_t)
//   dv_t = dS_tᵀ · k_t + (r_t · (u ⊙ k_t)) do_t
//   dw_t[i] = Σ_j dS_t[i,j] S_{t-1}[i,j]
//   du += r_t ⊙ k_t (v_t · do_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t ⊗ do_t,   d(s0) = dS_{-1}.
//
// Design.  Rows of S (and of dS) never meet: row i's recurrences read only
// w_t[i], k_t[i], r_t[i] and the shared v_t, do_t.  Only dv sums over rows.
// So one launch has two kinds of blocks, 256 threads each:
// * row blocks (blockIdx.y = 0, one a slab): thread (i, q) holds row i,
//   columns 16q .. 16q+15 of S and of dS; dr, dk, dw and du are sums
//   along its row, finished by a butterfly over the row's 4 lanes, and
//   d(s0) is its dS at the end;
// * column blocks (blockIdx.y = 1, one a slab): thread (j, q) holds
//   column j, rows 16q .. 16q+15 of dS only (no S), and writes dv, a sum
//   down its column, finished the same way.  This is kernel #7's
//   recurrence run backward in time with k and r swapped and do for v.
// dw and dr need S_{t-1} while dS runs backward in time.  S is never
// recovered by dividing by w (w = exp(-exp(.)) underflows toward 0);
// it is recomputed forward from checkpoints, in two levels:
// * a forward pass stores S every kChunk = 16 steps in global scratch
//   (BH · ceil(T/16) · 16 KB: 268 MB at BH = 512, T = 512);
// * walking the chunks backward, each chunk is run forward again from
//   its checkpoint, storing S every kSub = 4 steps in shared memory
//   (4 · 16 KB a block);
// * each 4-step piece is run forward once more from its sub-checkpoint
//   into registers (4 states of a thread's 16 elements), then walked
//   backward with dS.
// A thread only ever reads back the checkpoints it wrote itself, so they
// need no barrier.  Inputs: each chunk's r, k, w, v and do rows (16 steps,
// 20 KB) are copied by cp.async into one of two shared-memory stages while
// the other stage's chunk runs (the forward pass stages k, w and v only),
// so a step reads shared memory, not L2.  104 KB of shared memory and at
// most 128 registers a thread: two blocks an SM.
//
// The first version (no staging, checkpoints every 32 steps and every 4
// in L2-resident global scratch, 185 registers, one block an SM) took
// 7.11 ms at BH = 512, T = 512, where a step waited on its own global
// loads; this one takes 2.43 ms (chip_smoke.py phase 24, CUDA events, on
// an H100 80GB HBM3 at 700 W).
//
// Numerics.  f32 throughout, nvcc's default contraction of a*b+c into FMA;
// the sums run in other orders than autograd's, so results agree with the
// plain gradient within a few ulps of the terms' magnitude, not bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMax = 64;       // largest dk and dv
constexpr int kThreads = 256;  // a slab: 64 rows (or columns) x 4 lanes
constexpr int kStrip = 16;     // elements of a row (or column) a lane holds
constexpr int kChunk = 16;     // steps between the global checkpoints (a stage)
constexpr int kSub = 4;        // steps between the sub-checkpoints
constexpr int kSubs = kChunk / kSub;
constexpr int kState = kMax * kMax;  // floats of one checkpoint
static_assert(kMax * 4 == kThreads && 4 * kStrip == kMax && kChunk % kSub == 0,
              "four lanes of 16 a row");

struct Stage {
  float r[kChunk][kMax], k[kChunk][kMax], w[kChunk][kMax], v[kChunk][kMax], o[kChunk][kMax];
};
struct Smem {
  Stage stage[2];
  float4 sub[kSubs][4][kThreads];  // a lane's sub-checkpoints: [sub][float4][lane]
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

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Copies n rows of d floats (contiguous from src) into rows 0..n-1 of dst.
__device__ __forceinline__ void stage_rows(float (*dst)[kMax], const float* src, int n, int d,
                                           bool vec) {
  if (vec && d == kMax) {  // rows as wide as the stage's: one flat copy
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

struct Args {
  const float *r, *k, *v, *w, *u, *s0, *d_o, *ds_t;
  float *dr, *dk, *dv, *dw, *du, *ds0, *ckpt;
  int t_len, dk_, dv_;
  bool vec_k, vec_v;
};

// What a stage holds: k and w always, v and r / do as a pass needs them.
enum Needs { kForward, kRows, kColumns };

// Stages steps t0 .. t0+n-1 of the slab (the forward pass k, w, v; the
// row blocks' backward all five; the column blocks k, w, r, do).
__device__ __forceinline__ void stage_chunk(Stage& st, const Args& a, long long slab, int t0,
                                            int n, Needs needs) {
  const long long at = slab * a.t_len + t0;
  stage_rows(st.k, a.k + at * a.dk_, n, a.dk_, a.vec_k);
  stage_rows(st.w, a.w + at * a.dk_, n, a.dk_, a.vec_k);
  if (needs != kColumns) stage_rows(st.v, a.v + at * a.dv_, n, a.dv_, a.vec_v);
  if (needs != kForward) {
    stage_rows(st.r, a.r + at * a.dk_, n, a.dk_, a.vec_k);
    stage_rows(st.o, a.d_o + at * a.dv_, n, a.dv_, a.vec_v);
  }
  commit();
}

// Zeroes the stages' pad entries (rows i >= dk, columns j >= dv), which no
// copy writes: pad rows of S and dS then stay 0 and pad columns add 0.
__device__ __forceinline__ void zero_pads(Smem& sm, int dk, int dv) {
  if (dk == kMax && dv == kMax) return;
  for (int e = threadIdx.x; e < 2 * kChunk * kMax; e += kThreads) {
    Stage& st = sm.stage[e / (kChunk * kMax)];
    const int tt = (e / kMax) % kChunk, i = e % kMax;
    if (i >= dk) st.r[tt][i] = st.k[tt][i] = st.w[tt][i] = 0.0f;
    if (i >= dv) st.v[tt][i] = st.o[tt][i] = 0.0f;
  }
}

// 16 floats of a staged row from column c0.
__device__ __forceinline__ void row16(float* out, const float* row, int c0) {
#pragma unroll
  for (int e = 0; e < kStrip; e += 4) {
    *reinterpret_cast<float4*>(&out[e]) = *reinterpret_cast<const float4*>(row + c0 + e);
  }
}

// A lane's 16 floats of a global checkpoint: float4 e4 of lane tid at
// (e4 * 256 + tid), so a warp stores and loads 512 contiguous bytes.
__device__ __forceinline__ void put16(float4* p, const float* s) {
#pragma unroll
  for (int e4 = 0; e4 < 4; ++e4) {
    p[e4 * kThreads + threadIdx.x] = make_float4(s[4 * e4], s[4 * e4 + 1], s[4 * e4 + 2], s[4 * e4 + 3]);
  }
}

__device__ __forceinline__ void get16(float* s, const float4* p) {
#pragma unroll
  for (int e4 = 0; e4 < 4; ++e4) {
    const float4 x = p[e4 * kThreads + threadIdx.x];
    s[4 * e4] = x.x;
    s[4 * e4 + 1] = x.y;
    s[4 * e4 + 2] = x.z;
    s[4 * e4 + 3] = x.w;
  }
}

// Sum over the 4 lanes of a row (or column): lanes 4m .. 4m+3 of a warp.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Row i's strip one step forward from staged step tt: S = w[i] S + k[i] v.
__device__ __forceinline__ void row_step(float* s, const Stage& st, int tt, int i, int c0) {
  float vv[kStrip];
  row16(vv, st.v[tt], c0);
  const float ww = st.w[tt][i], kk = st.k[tt][i];
#pragma unroll
  for (int e = 0; e < kStrip; ++e) s[e] = ww * s[e] + kk * vv[e];
}

__device__ void row_block(const Args& a, Smem& sm, long long slab) {
  const int i = threadIdx.x >> 2, q = threadIdx.x & 3, c0 = kStrip * q;
  const int t_len = a.t_len, dk = a.dk_, dv = a.dv_;
  const int n_ck = (t_len + kChunk - 1) / kChunk;
  float4* ckpt = reinterpret_cast<float4*>(a.ckpt) + slab * n_ck * (kState / 4);
  const float uu = i < dk ? a.u[slab * dk + i] : 0.0f;

  // forward: S from s0, a checkpoint every kChunk steps (k, w, v staged)
  stage_chunk(sm.stage[0], a, slab, 0, min(kChunk, t_len), kForward);
  zero_pads(sm, dk, dv);
  float s[kStrip];
#pragma unroll
  for (int e = 0; e < kStrip; ++e) {
    const int j = c0 + e;
    s[e] = (a.s0 != nullptr && i < dk && j < dv) ? a.s0[(slab * dk + i) * dv + j] : 0.0f;
  }
  for (int c = 0; c < n_ck; ++c) {
    put16(ckpt + c * (kState / 4), s);
    if (c + 1 == n_ck) break;  // the last chunk's states come from its checkpoint
    wait_all();
    __syncthreads();  // chunk c staged for all; all done with chunk c-1's stage
    // the last chunk runs forward only in the backward pass
    if (c + 2 < n_ck) stage_chunk(sm.stage[(c + 1) & 1], a, slab, (c + 1) * kChunk, kChunk, kForward);
    const Stage& st = sm.stage[c & 1];
#pragma unroll 4
    for (int tt = 0; tt < kChunk; ++tt) row_step(s, st, tt, i, c0);
  }
  wait_all();
  __syncthreads();  // every thread is done with the forward's stages

  float ds[kStrip];
#pragma unroll
  for (int e = 0; e < kStrip; ++e) {
    const int j = c0 + e;
    ds[e] = (a.ds_t != nullptr && i < dk && j < dv) ? a.ds_t[(slab * dk + i) * dv + j] : 0.0f;
  }
  float du = 0.0f;
  {
    const int c = n_ck - 1;
    stage_chunk(sm.stage[c & 1], a, slab, c * kChunk, t_len - c * kChunk, kRows);
  }
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, t_len - t0);
    const int n_sub = (n + kSub - 1) / kSub;
    wait_all();
    __syncthreads();  // chunk c staged for all; all done with chunk c+1's stage
    if (c > 0) stage_chunk(sm.stage[(c - 1) & 1], a, slab, t0 - kChunk, kChunk, kRows);
    const Stage& st = sm.stage[c & 1];
    // the chunk again, from its checkpoint: a sub-checkpoint every kSub steps
    get16(s, ckpt + c * (kState / 4));
    for (int b = 0; b < n_sub; ++b) {
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        sm.sub[b][e4][threadIdx.x] = make_float4(s[4 * e4], s[4 * e4 + 1], s[4 * e4 + 2], s[4 * e4 + 3]);
      }
      if (b + 1 == n_sub) break;
#pragma unroll
      for (int m = 0; m < kSub; ++m) row_step(s, st, kSub * b + m, i, c0);
    }
    for (int b = n_sub - 1; b >= 0; --b) {
      const int ta = kSub * b;
      // hist[m] = S_{t0+ta+m-1}, the state staged step ta + m reads
      float hist[kSub][kStrip];
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float4 x = sm.sub[b][e4][threadIdx.x];
        hist[0][4 * e4] = x.x;
        hist[0][4 * e4 + 1] = x.y;
        hist[0][4 * e4 + 2] = x.z;
        hist[0][4 * e4 + 3] = x.w;
      }
#pragma unroll
      for (int m = 1; m < kSub; ++m) {
#pragma unroll
        for (int e = 0; e < kStrip; ++e) hist[m][e] = hist[m - 1][e];
        if (ta + m - 1 < n) row_step(hist[m], st, ta + m - 1, i, c0);
      }
#pragma unroll
      for (int m = kSub - 1; m >= 0; --m) {
        const int tt = ta + m;
        if (tt >= n) continue;
        float vv[kStrip], oo[kStrip];
        row16(vv, st.v[tt], c0);
        row16(oo, st.o[tt], c0);
        const float rr = st.r[tt][i], kk = st.k[tt][i], ww = st.w[tt][i];
        float p_dr = 0.0f, p_dk = 0.0f, p_dw = 0.0f, p_vdo = 0.0f;
#pragma unroll
        for (int e = 0; e < kStrip; ++e) {
          p_dr += hist[m][e] * oo[e];
          p_dk += ds[e] * vv[e];
          p_dw += ds[e] * hist[m][e];
          p_vdo += vv[e] * oo[e];
        }
        const float vdo = quad_sum(p_vdo);
        const float g_r = quad_sum(p_dr) + uu * kk * vdo;
        const float g_k = quad_sum(p_dk) + uu * rr * vdo;
        const float g_w = quad_sum(p_dw);
        du += rr * kk * vdo;
        if (i < dk) {
          const long long at = (slab * t_len + t0 + tt) * dk + i;
          if (q == 0) a.dr[at] = g_r;
          if (q == 1) a.dk[at] = g_k;
          if (q == 2) a.dw[at] = g_w;
        }
#pragma unroll
        for (int e = 0; e < kStrip; ++e) ds[e] = ww * ds[e] + rr * oo[e];
      }
    }
  }
  if (i < dk) {
    if (q == 0) a.du[slab * dk + i] = du;
    if (a.ds0 != nullptr) {
#pragma unroll
      for (int e = 0; e < kStrip; ++e) {
        const int j = c0 + e;
        if (j < dv) a.ds0[(slab * dk + i) * dv + j] = ds[e];
      }
    }
  }
}

__device__ void column_block(const Args& a, Smem& sm, long long slab) {
  const int j = threadIdx.x >> 2, q = threadIdx.x & 3, i0 = kStrip * q;
  const int t_len = a.t_len, dk = a.dk_, dv = a.dv_;
  const int n_ck = (t_len + kChunk - 1) / kChunk;
  float ds[kStrip], uu[kStrip];
#pragma unroll
  for (int e = 0; e < kStrip; ++e) {
    const int i = i0 + e;
    uu[e] = i < dk ? a.u[slab * dk + i] : 0.0f;
    ds[e] = (a.ds_t != nullptr && i < dk && j < dv) ? a.ds_t[(slab * dk + i) * dv + j] : 0.0f;
  }
  {
    const int c = n_ck - 1;
    stage_chunk(sm.stage[c & 1], a, slab, c * kChunk, t_len - c * kChunk, kColumns);
  }
  zero_pads(sm, dk, dv);
  for (int c = n_ck - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, t_len - t0);
    wait_all();
    __syncthreads();
    if (c > 0) stage_chunk(sm.stage[(c - 1) & 1], a, slab, t0 - kChunk, kChunk, kColumns);
    const Stage& st = sm.stage[c & 1];
#pragma unroll 2
    for (int tt = n - 1; tt >= 0; --tt) {
      float rr[kStrip], kk[kStrip], ww[kStrip];
      row16(rr, st.r[tt], i0);
      row16(kk, st.k[tt], i0);
      row16(ww, st.w[tt], i0);
      const float oo = st.o[tt][j];
      float p_dv = 0.0f, p_bonus = 0.0f;
#pragma unroll
      for (int e = 0; e < kStrip; ++e) {
        p_dv += kk[e] * ds[e];
        p_bonus += rr[e] * uu[e] * kk[e];
      }
      const float g_v = quad_sum(p_dv) + quad_sum(p_bonus) * oo;
      if (q == 0 && j < dv) a.dv[(slab * t_len + t0 + tt) * dv + j] = g_v;
#pragma unroll
      for (int e = 0; e < kStrip; ++e) ds[e] = ww[e] * ds[e] + rr[e] * oo;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) wkv6_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const long long slab = blockIdx.x;
  if (blockIdx.y == 0) {
    row_block(a, sm, slab);
  } else {
    column_block(a, sm, slab);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Largest dk and dv the kernel takes.
int wkv6_bwd_max_dim() { return kMax; }

// Floats of global scratch a launch needs for bh slabs of t_len steps.
long long wkv6_bwd_scratch_floats(int bh, int t_len) {
  const long long n_ck = (t_len + kChunk - 1) / kChunk;
  return static_cast<long long>(bh) * n_ck * kState;
}

// Launches kernel #7b on `stream`: r, k, w (bh, t, dk), v, d_o (bh, t, dv),
// u (bh, dk), s0 and ds_t (bh, dk, dv) or null (zeros) -> dr, dk, dw (bh,
// t, dk), dv (bh, t, dv), du (bh, dk), ds0 (bh, dk, dv) or null (not
// written); scratch holds wkv6_bwd_scratch_floats(bh, t) floats, 16-byte
// aligned.  Returns a cudaError_t (0 = launched).
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* s0, const void* d_o, const void* ds_t, void* dr, void* dk,
                    void* dv, void* dw, void* du, void* ds0, void* scratch, int bh, int t_len,
                    int dk_, int dv_, void* stream) {
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.d_o = static_cast<const float*>(d_o);
  a.ds_t = static_cast<const float*>(ds_t);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw = static_cast<float*>(dw);
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  a.ckpt = static_cast<float*>(scratch);
  a.t_len = t_len;
  a.dk_ = dk_;
  a.dv_ = dv_;
  a.vec_k = dk_ % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(w);
  a.vec_v = dv_ % 4 == 0 && aligned16(v) && aligned16(d_o);
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, 2);
  wkv6_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
