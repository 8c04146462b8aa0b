"""The RWKV-6 recurrence on the card: kernel #7 (``csrc/wkv6.cu``).

Twin of `repro.kernels.wkv6.wkv6_pallas`, with the contract of
`repro.kernels.ref.wkv6`.  `wkv6_kernel` launches one 64-thread block per
batch*head slab, which loops over all T steps in order with the (dk, dv)
state spread over its threads' registers (16 rows of 4 columns each) and
the next 32 steps' inputs copied into shared memory while the current ones
run; it takes any T >= 1 (no padding of T) and dk, dv up to 64.  Its sums
have a fixed order, so a run split into two launches equals one.
`wkv6_plain` (`ref.wkv6`) is the same recurrence in plain torch ops, what
`repro_torch.kernels.ops.wkv6` runs for CPU tensors.  The two agree within a
few ulps of the terms' magnitude (summation order), not bit for bit.

`wkv6_bwd_kernel` launches kernel #7b (``csrc/wkv6_bwd.cu``), the gradient
of the recurrence for r, k, v, w, u and the initial state, one launch for
all slabs and steps (the design, and its scratch of checkpointed states, in
the source's header).  `wkv6_bwd_plain` is its plain version: the gradient
of `ref.wkv6` under autograd.  They agree within a few ulps of the terms'
magnitude, as the forward pair does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check, raise_if, stream_of
from repro_torch.kernels.ref import wkv6 as wkv6_plain

__all__ = ["wkv6_kernel", "wkv6_plain", "wkv6_bwd_kernel", "wkv6_bwd_plain", "MAX_DIM"]

MAX_DIM = 64  # csrc/wkv6.cu: kMax
_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("wkv6")
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_launch.argtypes = [_P] * 8 + [ctypes.c_int] * 4 + [_P]
    lib.wkv6_max_dim.restype = ctypes.c_int
    if lib.wkv6_max_dim() != MAX_DIM:
        raise RuntimeError(f"csrc/wkv6.cu takes dims up to {lib.wkv6_max_dim()}, "
                           f"the wrapper expects {MAX_DIM}")
    return lib


def wkv6_kernel(r, k, v, w, u, initial_state=None):
    """Kernel #7: ``(o, final_state)`` of the recurrence, one launch.

    Args:
      r, k, w: (BH, T, dk) f32 on CUDA; v: (BH, T, dv) f32; u: (BH, dk) f32;
      initial_state: (BH, dk, dv) f32 or None (zeros).  All contiguous.
    """
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"kernel #7 (wkv6) needs CUDA tensors, got {dev}")
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"wkv6 takes (BH, T, d) slabs, got r {tuple(r.shape)}, "
                         f"v {tuple(v.shape)}")
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"kernel #7 (wkv6) takes 1 <= dk, dv <= {MAX_DIM}, "
                         f"got dk={dk}, dv={dv}")
    if t < 1 or not 1 <= bh < 2 ** 31:
        raise ValueError(f"wkv6 needs T >= 1 and 1 <= BH < 2^31, got T={t}, BH={bh}")
    for name, x, shape in (("r", r, (bh, t, dk)), ("k", k, (bh, t, dk)),
                           ("w", w, (bh, t, dk)), ("v", v, (bh, t, dv)),
                           ("u", u, (bh, dk))):
        check(x, name, torch.float32, shape, dev)
    if initial_state is not None:
        check(initial_state, "initial_state", torch.float32, (bh, dk, dv), dev)
    o = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
    s_out = torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
    s0 = None if initial_state is None else initial_state.data_ptr()
    with torch.cuda.device(dev):
        err = _lib().wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0, o.data_ptr(), s_out.data_ptr(), bh, t, dk, dv, stream_of(dev),
        )
    raise_if(err, "wkv6")
    build.launches["wkv6"] += 1
    return o, s_out


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("wkv6_bwd")
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [_P] * 15 + [ctypes.c_int] * 4 + [_P]
    lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 2
    lib.wkv6_bwd_max_dim.restype = ctypes.c_int
    if lib.wkv6_bwd_max_dim() != MAX_DIM:
        raise RuntimeError(f"csrc/wkv6_bwd.cu takes dims up to {lib.wkv6_bwd_max_dim()}, "
                           f"the wrapper expects {MAX_DIM}")
    return lib


def wkv6_bwd_kernel(r, k, v, w, u, initial_state, d_o, d_state, need_state_grad=True):
    """Kernel #7b: ``(dr, dk, dv, dw, du, d_initial_state)``, one launch.

    Args: the forward's inputs as `wkv6_kernel` takes them; ``d_o`` (BH, T,
    dv) f32, the gradient of ``o``; ``d_state`` (BH, dk, dv) f32 or None
    (zeros), the gradient of the final state.  ``d_initial_state`` is None
    when ``need_state_grad`` is false.
    """
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"kernel #7b (wkv6_bwd) needs CUDA tensors, got {dev}")
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"wkv6_bwd takes (BH, T, d) slabs, got r {tuple(r.shape)}, "
                         f"v {tuple(v.shape)}")
    bh, t, dk = r.shape
    dv = v.shape[-1]
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"kernel #7b (wkv6_bwd) takes 1 <= dk, dv <= {MAX_DIM}, "
                         f"got dk={dk}, dv={dv}")
    if t < 1 or not 1 <= bh < 2 ** 31:
        raise ValueError(f"wkv6_bwd needs T >= 1 and 1 <= BH < 2^31, got T={t}, BH={bh}")
    for name, x, shape in (("r", r, (bh, t, dk)), ("k", k, (bh, t, dk)),
                           ("w", w, (bh, t, dk)), ("v", v, (bh, t, dv)),
                           ("u", u, (bh, dk)), ("d_o", d_o, (bh, t, dv))):
        check(x, name, torch.float32, shape, dev)
    for name, x in (("initial_state", initial_state), ("d_state", d_state)):
        if x is not None:
            check(x, name, torch.float32, (bh, dk, dv), dev)
    lib = _bwd_lib()
    dr, dk_, dw = (torch.empty((bh, t, dk), dtype=torch.float32, device=dev)
                   for _ in range(3))
    dv_ = torch.empty((bh, t, dv), dtype=torch.float32, device=dev)
    du = torch.empty((bh, dk), dtype=torch.float32, device=dev)
    ds0 = (torch.empty((bh, dk, dv), dtype=torch.float32, device=dev)
           if need_state_grad else None)
    scratch = torch.empty(int(lib.wkv6_bwd_scratch_floats(bh, t)), dtype=torch.float32,
                          device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = lib.wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            ptr(initial_state), d_o.data_ptr(), ptr(d_state), dr.data_ptr(),
            dk_.data_ptr(), dv_.data_ptr(), dw.data_ptr(), du.data_ptr(), ptr(ds0),
            scratch.data_ptr(), bh, t, dk, dv, stream_of(dev),
        )
    raise_if(err, "wkv6_bwd")
    build.launches["wkv6_bwd"] += 1
    return dr, dk_, dv_, dw, du, ds0


def wkv6_bwd_plain(r, k, v, w, u, initial_state, d_o, d_state):
    """The plain version of kernel #7b: the gradient of `ref.wkv6` under
    autograd, ``(dr, dk, dv, dw, du, d_initial_state)`` (the last zeros
    when there is no initial state, as the kernel's would be)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in (r, k, v, w, u)]
        s0 = (torch.zeros((r.shape[0], r.shape[-1], v.shape[-1]), dtype=r.dtype,
                          device=r.device) if initial_state is None
              else initial_state.detach()).requires_grad_()
        o, s = wkv6_plain(*xs, s0)
        outs, grads = [o], [d_o]
        if d_state is not None:
            outs.append(s)
            grads.append(d_state)
        return torch.autograd.grad(outs, [*xs, s0], grads)
