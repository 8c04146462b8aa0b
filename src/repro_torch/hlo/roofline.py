"""Three-term roofline model on NVIDIA H100 80GB HBM3 SXM constants (twin
of `repro.hlo.roofline`, whose constants are TPU v5e's).

    T_comp = flops a rank / 989e12             (dense bf16 peak)
    T_mem  = HBM bytes a rank / 3.35e12
    T_coll = the bytes a rank sends on each mesh axis / that axis's link

Every constant is a data-sheet figure for one NVIDIA H100 80GB HBM3 SXM
(none is measured here).  A mesh's ranks are numbered row-major (the last
axis fastest, as `repro_torch.launch.dryrun` builds the mesh) and packed
``NODE_GPUS`` to a node: an axis whose every group lies inside one node
crosses NVLink 4 (``NVLINK_BW`` each way a GPU), any other a node's NICs
(one 400 Gb/s NIC a GPU, ``NIC_BW``), which bound its ring.  On the
production meshes (16 x 16, 2 x 16 x 16) every axis spans more than a node.

`Roofline` keeps JAX's terms and definitions (`dominant`,
`fraction_of_roofline`, `mfu_bound`, ...); its collective term is the
per-axis sum (``coll_seconds``) where the caller has it, else the wire
bytes at ``NIC_BW``.  `analytic_hbm_bytes` and `model_flops` are JAX's
arithmetic unchanged.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PEAK_FLOPS", "HBM_BW", "NODE_GPUS", "NVLINK_BW", "NIC_BW", "INT32_OPS", "axis_links",
           "collective_seconds", "Roofline", "analytic_hbm_bytes", "model_flops"]

PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores, a GPU (data sheet)
HBM_BW = 3.35e12  # bytes/s, a GPU (data sheet)
NODE_GPUS = 8  # GPUs an HGX H100 node joins by NVLink
NVLINK_BW = 450e9  # bytes/s each way a GPU: NVLink 4, 900 GB/s both ways (data sheet)
NIC_BW = 50e9  # bytes/s each way a GPU: one 400 Gb/s NIC a GPU (data sheet)
# 32-bit integer instructions a second (the Threefry kernels' bound): 132 SMs
# x 128 lanes x the 1.98 GHz boost clock behind the data sheet's fp32 rate
INT32_OPS = 132 * 128 * 1.98e9


def axis_links(names, sizes) -> dict:
    """Mesh axis -> (link, bytes/s) for a mesh of axis ``names`` and
    ``sizes`` (major first) over row-major ranks: ``"nvlink"`` where each
    of the axis's groups lies in one node of ``NODE_GPUS``, else ``"nic"``."""
    out, stride = {}, 1
    for name, size in reversed(list(zip(names, sizes))):
        span = stride * size
        inside = size == 1 or (span <= NODE_GPUS and NODE_GPUS % span == 0)
        out[name] = ("nvlink", NVLINK_BW) if inside else ("nic", NIC_BW)
        stride = span
    return dict(reversed(list(out.items())))


def collective_seconds(wire_by_axis: dict, names, sizes) -> float:
    """The collective term: each axis's wire bytes a rank over its link's
    rate, summed (an axis of no known name: the NIC's)."""
    links = axis_links(names, sizes)
    return sum(b / links.get(axis, ("nic", NIC_BW))[1] for axis, b in wire_by_axis.items())


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float  # counted (unfused: an upper bound)
    coll_wire_bytes_per_device: float
    model_flops_global: float  # 6·N·D (train) or 2·N_active·tokens (serve)
    n_devices: int
    hbm_analytic_per_device: float = 0.0  # minimum-traffic model (lower bound)
    coll_seconds: float | None = None  # per-axis links (`collective_seconds`)

    @property
    def t_comp(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_mem(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_mem_analytic(self) -> float:
        return self.hbm_analytic_per_device / HBM_BW

    @property
    def t_coll(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_wire_bytes_per_device / NIC_BW

    @property
    def dominant(self) -> str:
        """Dominant term under the counted memory bytes."""
        terms = {"compute": self.t_comp, "memory": self.t_mem, "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def dominant_analytic(self) -> str:
        """Dominant term with the analytic (fused) memory model: the counted
        bytes charge every op's inputs and outputs, as if nothing fused."""
        terms = {"compute": self.t_comp, "memory": self.t_mem_analytic,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_comp, self.t_mem, self.t_coll)

    @property
    def bound_time_analytic(self) -> float:
        return max(self.t_comp, self.t_mem_analytic, self.t_coll)

    @property
    def fraction_of_roofline(self) -> float:
        """T_comp / max-term: 1.0 = perfectly compute-bound at peak."""
        return self.t_comp / self.bound_time if self.bound_time else 0.0

    @property
    def fraction_of_roofline_analytic(self) -> float:
        return self.t_comp / self.bound_time_analytic if self.bound_time_analytic else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops (catches remat/redundancy waste)."""
        counted = self.flops_per_device * self.n_devices
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-FLOPs utilization implied by the roofline:
        useful flops / (GPUs · peak · bound_time)."""
        denom = self.n_devices * PEAK_FLOPS * self.bound_time
        return self.model_flops_global / denom if denom else 0.0

    def row(self) -> dict:
        return {
            "t_comp_s": self.t_comp,
            "t_mem_s": self.t_mem,
            "t_mem_analytic_s": self.t_mem_analytic,
            "t_coll_s": self.t_coll,
            "dominant": self.dominant,
            "dominant_analytic": self.dominant_analytic,
            "bound_time_s": self.bound_time,
            "fraction_of_roofline": self.fraction_of_roofline,
            "fraction_of_roofline_analytic": self.fraction_of_roofline_analytic,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analytic_hbm_bytes(cfg, shape_kind: str, batch: int, seq: int,
                       n_model: int, n_batchpar: int) -> float:
    """Minimum-HBM-traffic model per device per step (lower bound; JAX's
    arithmetic).

    train:   28·P/chips        master f32 params r/w + Adam m,v r/w + grad r
           +  2·P_active/n_model   step-start bf16 weight cast/gather write
           +  3·2·P_active/n_model bf16 weight reads (fwd + remat-fwd + bwd)
           + ACT_TRAIN streams of (B_loc·S·d·2B) per layer
           + chunked-CE logits r/w
    prefill: bf16 weight read + ACT_PREFILL act streams + KV-cache write
    decode:  bf16 active-weight read + KV-cache (or recurrent-state) r/w
             + per-token activations (negligible but counted)
    """
    p_total, p_act = cfg.n_params, cfg.n_active_params
    chips = n_model * n_batchpar
    d = cfg.d_model
    n_layers = cfg.n_layers + (cfg.enc_layers or 0)
    tok_loc = batch * seq / n_batchpar
    if cfg.family not in ("rwkv",):
        # kv cache bytes across layers (hybrid: only attention layers)
        n_attn = n_layers
        if cfg.family == "hybrid":
            pat = cfg.pattern or ("attn",)
            n_attn = sum(1 for i in range(cfg.n_layers) if pat[i % len(pat)].startswith("attn"))
        eff_seq = seq
        window = cfg.local_window if cfg.family == "hybrid" else cfg.swa_window
        if cfg.ring_cache and window:
            eff_seq = min(seq, window)  # ring-buffer cache
        kv_bytes_total = n_attn * batch * cfg.n_kv_heads * eff_seq * cfg.head_dim * 2 * 2
    else:
        kv_bytes_total = cfg.n_layers * batch * (cfg.d_model // 64) * 64 * 64 * 4 * 2

    if shape_kind == "train":
        act_streams = 40.0  # fwd(~14 tensors r+w) + remat refwd + bwd ≈ 40
        opt = 28.0 * p_total / chips
        gather = 2.0 * p_act / n_model
        wreads = 6.0 * p_act / n_model
        acts = n_layers * tok_loc * d * 2.0 * act_streams
        logits = tok_loc * (cfg.vocab / n_model) * 4.0 * 2.0
        return opt + gather + wreads + acts + logits
    if shape_kind == "prefill":
        act_streams = 16.0
        wreads = 2.0 * p_act / n_model
        acts = n_layers * tok_loc * d * 2.0 * act_streams
        cache_w = kv_bytes_total / chips / 2  # write once
        return wreads + acts + cache_w
    # decode: every step reads all active weights + the (masked) cache
    wreads = 2.0 * p_act / n_model
    cache_rw = kv_bytes_total / chips
    acts = n_layers * (batch / n_batchpar) * d * 2.0 * 12.0
    return wreads + cache_rw + acts


def model_flops(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS for a step.

    train: 6·N_active·tokens (fwd 2x + bwd 4x), tokens = batch·seq.
    prefill: 2·N_active·tokens.
    decode: 2·N_active·batch (one token per sequence).
    """
    n = cfg.n_active_params
    if shape_kind == "train":
        return 6.0 * n * batch * seq
    if shape_kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch
