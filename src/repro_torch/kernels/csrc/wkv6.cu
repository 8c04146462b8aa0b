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
// Design.  The TPU kernel walks a (BH, T/chunk) grid whose minor dimension
// runs in order and keeps S in VMEM scratch between chunks.  Blocks here run
// in no order, so the time loop lives inside the block: one block of 64
// threads per slab, thread j owning column j of S in 64 registers.  Time
// steps are staged TC at a time into shared memory (r, k, w, v: 32 KB at
// TC = 32), with coalesced loads of the contiguous (TC, dk) rows; the bonus
// Σ r·u·k of each staged step is computed by one thread per step, in index
// order, before the steps run.  Within a step every thread reads the same
// r, k, w (shared-memory broadcast) and its own v, so there is no reduction
// across threads and every sum has a fixed order.
//
// Padding.  S always has 64 rows in registers.  Rows i >= dk start at zero
// and see k = 0 (and r = 0) forever, so they stay zero and add nothing.  The
// JAX wrapper pads T to a multiple of its chunk with w = 1, k = 0 steps,
// which leave the state unchanged; this kernel needs no padding in T: the
// last staged chunk simply runs fewer steps.
//
// Bound.  Per slab and step it reads 3dk + dv floats and writes dv, and does
// ~4·dk·dv flops; S is read and written once.  At the serving shapes
// (dk = dv = 64, BH = 256) that is far below a microsecond per step of
// either memory or ALU time: a T-long dependent chain per slab is latency,
// not bandwidth.  The design keeps each step's chain short: the out-product
// uses four partial sums, and the staged chunk hides global-memory latency.
//
// Numerics.  f32 throughout; summation order differs from the plain version
// (nvcc contracts a*b+c into FMA), so results agree within a few ulps of the
// terms' magnitude, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kMax = 64;      // largest dk and dv
constexpr int kThreads = 64;  // one thread per column of S
constexpr int kTc = 32;       // time steps staged per chunk

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int t_len, int dk,
            int dv) {
  __shared__ float r_s[kTc][kMax];
  __shared__ float k_s[kTc][kMax];
  __shared__ float w_s[kTc][kMax];
  __shared__ float v_s[kTc][kMax];
  __shared__ float u_s[kMax];
  __shared__ float bonus_s[kTc];

  const int j = threadIdx.x;
  const long long slab = blockIdx.x;
  const float* r_b = r + slab * t_len * dk;
  const float* k_b = k + slab * t_len * dk;
  const float* w_b = w + slab * t_len * dk;
  const float* v_b = v + slab * t_len * dv;
  float* o_b = o + slab * t_len * dv;

  // rows i >= dk of r and k stay 0, of w 1; columns j >= dv of v stay 0
  for (int e = j; e < kTc * kMax; e += kThreads) {
    (&r_s[0][0])[e] = 0.0f;
    (&k_s[0][0])[e] = 0.0f;
    (&w_s[0][0])[e] = 1.0f;
    (&v_s[0][0])[e] = 0.0f;
  }
  u_s[j] = j < dk ? u[slab * dk + j] : 0.0f;

  float s[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    s[i] = (s0 != nullptr && i < dk && j < dv) ? s0[(slab * dk + i) * dv + j] : 0.0f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < t_len; t0 += kTc) {
    const int n = min(kTc, t_len - t0);
    for (int e = j; e < n * dk; e += kThreads) {
      const int tt = e / dk, i = e - tt * dk;
      r_s[tt][i] = r_b[(long long)t0 * dk + e];
      k_s[tt][i] = k_b[(long long)t0 * dk + e];
      w_s[tt][i] = w_b[(long long)t0 * dk + e];
    }
    for (int e = j; e < n * dv; e += kThreads) {
      const int tt = e / dv, i = e - tt * dv;
      v_s[tt][i] = v_b[(long long)t0 * dv + e];
    }
    __syncthreads();
    if (j < n) {
      float b = 0.0f;
      for (int i = 0; i < dk; ++i) b += r_s[j][i] * u_s[i] * k_s[j][i];
      bonus_s[j] = b;
    }
    __syncthreads();

    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        acc[i & 3] += r_s[tt][i] * s[i];
        s[i] = w_s[tt][i] * s[i] + k_s[tt][i] * vj;
      }
      if (j < dv) {
        o_b[(long long)(t0 + tt) * dv + j] =
            ((acc[0] + acc[1]) + (acc[2] + acc[3])) + bonus_s[tt] * vj;
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  if (j < dv) {
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < dk) s_out[(slab * dk + i) * dv + j] = s[i];
    }
  }
}

}  // namespace

extern "C" {

// Largest dk and dv the kernel takes.
int wkv6_max_dim() { return kMax; }

// Launches kernel #7 on `stream`: one block per slab of r, k, w (bh, t, dk),
// v (bh, t, dv), u (bh, dk), s0 (bh, dk, dv) or null (zeros) -> o (bh, t,
// dv), s_out (bh, dk, dv).  Returns cudaGetLastError() (0 = launched).
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* o, void* s_out, int bh,
                int t_len, int dk, int dv, void* stream) {
  wkv6_kernel<<<bh, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), t_len, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
