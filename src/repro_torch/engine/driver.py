"""Chunked PT driver on one device (twin of `repro.engine.driver`).

Ports the three branches of `repro.engine.driver.make_interval_step` and
the chunked host loop of `repro.engine.Engine`:

* **fused_round** — each interval is one call of the system's
  ``batched_mcmc_round``: one launch (kernel A, #2p or #5) of S sweeps
  whose last block runs the temp-mode exchange drawn from the counter swap
  stream at ``phase``;
* **fused** — ``batched_mcmc_interval`` for the sweeps (kernel A or #5),
  then the exchange strategy's swap phase in torch (`repro_torch.exchange`:
  DEO, SEO, windowed or VMPT) keyed on ``fold_in(key, 2t+1)``, the JAX
  engine's key;
* **per sweep** (the default, and the only path of the systems without a
  fused kernel: EA, the Gaussian mixture, HP, Ising ``single_flip``) — S
  calls of the system's ``batched_mcmc_step(key, t, states, betas)``, which
  draws replica r's randomness from ``fold_in(fold_in(key, 2t), r)`` as
  JAX's ``_sweep_once`` keys its ``vmap`` (one ``jax.random`` draw and one
  sweep of kernel #1 or #4; the EA sweep in torch on the same draw; one
  launch of ``csrc/serial_chain.cu`` for HP's moves and ``single_flip``'s
  flips), with the energy advanced after every sweep as JAX's scan
  advances it, then the same swap phase as the fused branch.

A state is a tensor or a dict of tensors (``{"spins", "jr", "jd"}`` for
EA), each with a leading replica axis.  The swap phase moves rungs
(``swap_mode="temp"``) or, in ``"state"`` mode, gathers every leaf of the
states and the energies into fresh tensors with ``index_select`` while
rungs stay the identity.  A waste-recycling
strategy (VMPT, ``n_virtual = 2``) records both outcomes of every pair
before the swap, stacked ``(2, R)``, with its ``est_weight`` row.

PyTorch runs eagerly, so a "chunk" is ``chunk_intervals`` intervals issued
back to back; ``t`` and ``phase`` are device scalars advanced on the device,
so the interval loop never waits for the card.  The host reads the O(R)
counters once per chunk, for the ladder feedback.

The ensemble axis (``n_chains = C > 1``) stacks C independent chains
``(C, R, ...)``; chain ``c`` is seeded from ``fold_in(key, c)``, so its
trajectory does not depend on C.  Where JAX ``vmap``s the chunk over the
chains, the engine runs each chain's chunk in turn on its slice of the
stacked state (a host loop: C launches of each kernel per interval, still
with no host sync) and stacks the results at the chunk's end.

`Engine.restore` reads the newest checkpoint of a
`repro_torch.checkpoint.CheckpointManager` onto the engine's device.  Not
ported yet, and refused with `NotImplementedError`: ``mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.core import keys
from repro_torch.core.pt import PTState, init_replicas, map_states
from repro_torch.device import resolve_device
from repro_torch.engine import stats as stats_lib
from repro_torch.engine.adapt import AdaptConfig, AdaptState, maybe_adapt
from repro_torch.engine.stats import map_leaves, stack_leaves
from repro_torch.exchange import DEO, ExchangeStrategy, make_strategy
from repro_torch.kernels import exchange as kernel_exchange

__all__ = [
    "StepSpec",
    "EngineConfig",
    "EngineState",
    "RunResult",
    "ChunkInfo",
    "AdaptInfo",
    "Engine",
    "make_interval_step",
]


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Static shape of one PT interval: sweeps, then one swap phase."""

    n_replicas: int
    sweeps_per_interval: int
    do_swap: bool = True
    criterion: str = "logistic"
    swap_mode: str = "temp"
    exchange: ExchangeStrategy = DEO()

    def __post_init__(self):
        if self.sweeps_per_interval < 1:
            raise ValueError("sweeps_per_interval must be >= 1")
        if self.criterion not in kernel_exchange.CRITERIA:
            raise ValueError(
                f"unknown criterion {self.criterion!r}; "
                f"allowed: {list(kernel_exchange.CRITERIA)}"
            )


def _inverse(rung: torch.Tensor) -> torch.Tensor:
    """Slot holding each rung (``argsort`` of a permutation)."""
    inv = torch.empty_like(rung, dtype=torch.int64)
    inv[rung.long()] = torch.arange(rung.shape[0], device=rung.device)
    return inv


def _observe(observables, st: PTState) -> dict[str, torch.Tensor]:
    """Per-rung series in rung order (cold→hot)."""
    inv = _inverse(st.rung)
    out = {"energy": st.energy[inv]}
    for name, fn in observables.items():
        out[name] = fn(st.states)[inv]
    return out


def _swap_decision(spec: StepSpec, betas, st: PTState):
    """Propose + accept this iteration's exchanges; ``(partner, perm, diag)``
    with ``perm`` the accepted permutation in rung space."""
    k_swap = keys.fold_in(st.key, 2 * st.t + 1)
    e_rung = st.energy[_inverse(st.rung)]
    partner = spec.exchange.propose_pairs(k_swap, st.phase, spec.n_replicas)
    perm, accept, prob, attempt = spec.exchange.accept(
        k_swap, partner, betas, e_rung, spec.criterion)
    return partner, perm, {"swap_accept": accept, "swap_prob": prob,
                           "swap_attempt": attempt}


def _apply_swap(spec: StepSpec, st: PTState, perm) -> PTState:
    """Apply an accepted rung permutation and advance the phase counter."""
    if spec.swap_mode == "temp":
        # slot s held rung[s]; it now holds perm[rung[s]]
        st = dataclasses.replace(st, rung=perm[st.rung.long()].to(torch.int32))
    else:
        # rung == slot: move the states themselves (every leaf), into fresh tensors
        st = dataclasses.replace(
            st, states=map_states(st.states, lambda x: torch.index_select(x, 0, perm)),
            energy=st.energy[perm])
    return dataclasses.replace(st, phase=st.phase + 1)


def _round_interval(system, spec: StepSpec):
    """The whole-round path when the system selects it (else None)."""
    if not getattr(system, "use_fused_round", False):
        return None
    pairing = spec.exchange.name
    if not (spec.do_swap and spec.swap_mode == "temp"
            and pairing in kernel_exchange.PAIRINGS and spec.exchange.n_virtual == 1):
        raise ValueError(
            "use_fused_round=True folds the exchange into the kernel and "
            "supports only temp-mode DEO/SEO with swaps on; got "
            f"do_swap={spec.do_swap}, swap_mode={spec.swap_mode!r}, "
            f"exchange={pairing!r} (n_virtual={spec.exchange.n_virtual})"
        )
    return system.batched_mcmc_round


def make_interval_step(system, spec: StepSpec, observables=None):
    """Build ``(PTState, betas) -> (PTState, record)`` for one interval.

    ``record`` holds per-rung ``energy``, each observable, and
    ``swap_accept``/``swap_prob``/``swap_attempt`` at the lower rung of
    each attempted pair.  With a waste-recycling strategy the series are
    the pre-swap values of both outcomes, ``(2, R)``, beside ``est_weight``.
    """
    observables = dict(observables or {})
    fused_round = _round_interval(system, spec)
    fused = getattr(system, "use_fused", False)
    recycle = spec.do_swap and spec.exchange.n_virtual > 1
    spi = spec.sweeps_per_interval

    def sweeps(st: PTState, betas: torch.Tensor) -> PTState:
        """The interval's S sweeps, without the exchange."""
        betas_slot = betas[st.rung.long()]
        if fused:
            states, de, _ = system.batched_mcmc_interval(
                st.key, st.t, st.states, betas_slot, n_sweeps=spi
            )
            return dataclasses.replace(
                st, states=states, energy=st.energy + de, t=st.t + spi
            )
        for _ in range(spi):
            # JAX's _sweep_once: energy and t advance after every sweep
            states, de, _ = system.batched_mcmc_step(st.key, st.t, st.states, betas_slot)
            st = dataclasses.replace(
                st, states=states, energy=st.energy + de, t=st.t + 1
            )
        return st

    def interval_step(st: PTState, betas: torch.Tensor):
        if fused_round is not None:
            states, rung, energy, _, acc, prob, att = fused_round(
                st.key, st.t, st.phase, st.states, st.rung, st.energy, betas,
                n_sweeps=spi, criterion=spec.criterion,
                pairing=spec.exchange.name,
            )
            st = dataclasses.replace(
                st, states=states, rung=rung, energy=energy,
                t=st.t + spi, phase=st.phase + 1,
            )
            rec = _observe(observables, st)
            rec.update(swap_accept=acc[0], swap_prob=prob[0], swap_attempt=att[0])
            return st, rec
        st = sweeps(st, betas)
        if recycle:
            # both outcomes of every attempted pair, pre-swap, in rung order
            partner, perm, diag = _swap_decision(spec, betas, st)
            pre = _observe(observables, st)
            rec = {k: torch.stack([v, v[partner]]) for k, v in pre.items()}
            rec["est_weight"] = spec.exchange.estimator_weights(partner, diag["swap_prob"])
            st = _apply_swap(spec, st, perm)
        else:
            if spec.do_swap:
                _, perm, diag = _swap_decision(spec, betas, st)
                st = _apply_swap(spec, st, perm)
            else:
                z = torch.zeros(spec.n_replicas, device=st.energy.device)
                diag = {"swap_accept": z.bool(), "swap_prob": z, "swap_attempt": z.bool()}
            rec = _observe(observables, st)
        rec.update(diag)
        return st, rec

    return interval_step


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (see `repro.engine.EngineConfig`).

    ``donate`` is accepted for spec compatibility; PyTorch has no buffer
    donation and the engine simply rebinds its state tensors.
    """

    n_replicas: int
    swap_interval: int = 100
    criterion: str = "logistic"
    swap_mode: str = "temp"
    chunk_intervals: int = 8
    n_chains: int = 1
    record_trace: bool = False
    track_stats: bool = True
    measure_interval: int = 100
    donate: bool = True
    exchange: Any = None
    mesh: Any = None

    def __post_init__(self):
        if self.chunk_intervals < 1:
            raise ValueError("chunk_intervals must be >= 1")
        if self.n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        if self.mesh is not None:
            raise NotImplementedError("not yet ported: mesh (multi-device engine)")
        if self.swap_mode not in ("temp", "state"):
            raise ValueError(f"bad swap_mode {self.swap_mode!r}")
        object.__setattr__(self, "exchange", make_strategy(self.exchange))

    @property
    def spec(self) -> StepSpec:
        interval = self.swap_interval if self.swap_interval > 0 else self.measure_interval
        return StepSpec(
            n_replicas=self.n_replicas,
            sweeps_per_interval=interval,
            do_swap=self.swap_interval > 0,
            criterion=self.criterion,
            swap_mode=self.swap_mode,
            exchange=self.exchange,
        )


@dataclasses.dataclass
class EngineState:
    """Device-resident engine state: chain(s), accumulators, (R,) f32 betas.

    ``pt`` and ``stats`` leaves carry a leading chain axis ``C`` when
    ``n_chains > 1``; the ladder is shared.
    """

    pt: PTState
    stats: stats_lib.OnlineStats
    betas: torch.Tensor


@dataclasses.dataclass
class RunResult:
    """Host-side outcome of `Engine.run` (see `repro.engine.RunResult`)."""

    summary: dict[str, np.ndarray]
    trace: dict[str, np.ndarray] | None
    ladder_history: np.ndarray
    n_sweeps: int
    stopped_early: bool = False


@dataclasses.dataclass
class ChunkInfo:
    index: int
    sweeps_done: int
    n_sweeps: int
    state: EngineState
    trace: dict[str, np.ndarray] | None


@dataclasses.dataclass
class AdaptInfo:
    round: int
    temps: np.ndarray
    acceptance: np.ndarray
    sweeps_done: int


def _counters(state: EngineState) -> dict[str, np.ndarray]:
    """Cumulative swap (``attempts``, ``accepts``) and flow (``up``,
    ``labeled``) counters on the host, pooled over the ensemble axis (one
    sync per chunk)."""
    out = {}
    for name, leaf in (("attempts", state.stats.swap_attempts),
                       ("accepts", state.stats.swap_accepts),
                       ("up", state.stats.up_visits),
                       ("labeled", state.stats.labeled_visits)):
        arr = leaf.cpu().numpy().astype(np.float64)
        out[name] = arr.sum(axis=0) if arr.ndim == 2 else arr
    return out


def _state_tensors(state: EngineState):
    """(name, tensor) for every tensor of an engine state."""
    for f in dataclasses.fields(state.pt):
        v = getattr(state.pt, f.name)
        items = v.items() if isinstance(v, dict) else [("", v)]
        for k, x in items:
            yield f"pt.{f.name}" + (f".{k}" if k else ""), x
    for f in dataclasses.fields(state.stats):
        v = getattr(state.stats, f.name)
        items = v.items() if isinstance(v, dict) else [("", v)]
        for k, x in items:
            yield f"stats.{f.name}" + (f".{k}" if k else ""), x
    yield "betas", state.betas


def _betas(temps: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy((1.0 / np.asarray(temps, np.float64)).astype(np.float32)).to(device)


class Engine:
    """Chunked PT driver over a `System` on one device.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels.
    """

    def __init__(
        self,
        system,
        config: EngineConfig,
        observables: Mapping[str, Callable] | None = None,
        adapt: AdaptConfig | None = None,
        device="cuda",
    ):
        if adapt is not None and not config.track_stats:
            raise ValueError(
                "adaptive ladders need the online swap counters: "
                "EngineConfig(track_stats=True) is required with adapt"
            )
        if adapt is not None and adapt.mode == "flow" and config.swap_mode != "temp":
            raise ValueError(
                "flow-optimized ladders consume the rung-flow diagnostic, "
                "which only exists in swap_mode='temp' (in 'state' mode "
                "rungs are pinned to slots)"
            )
        self.system = system
        self.config = config
        self.observables = dict(observables or {})
        self.adapt = adapt
        self.device = resolve_device(device)
        self._step = make_interval_step(system, config.spec, self.observables)
        self._names = ["energy"] + sorted(self.observables)
        self._adapt_rounds = 0
        self._adapt_state: AdaptState | None = None
        # the authoritative f64 ladder behind the f32 betas
        self._temps: np.ndarray | None = None

    def _chain_axis(self) -> int:
        """``n_chains`` for `stats.init_stats`: 0 means no ensemble axis."""
        c = self.config.n_chains
        return 0 if c == 1 else c

    def init(self, key: torch.Tensor, temps) -> EngineState:
        """Fresh state on the given ladder from a (2,) key.

        One chain starts from ``key`` itself; with an ensemble, chain ``c``
        starts from ``fold_in(key, c)``.
        """
        temps = np.asarray(temps, np.float64)
        if temps.shape != (self.config.n_replicas,):
            raise ValueError(
                f"ladder shape {temps.shape} != (n_replicas={self.config.n_replicas},)"
            )
        self._temps = temps.copy()
        self._adapt_state = None
        return self._fresh_state(key.to(self.device), temps, self.device)

    def _fresh_state(self, key, temps, device) -> EngineState:
        r, c = self.config.n_replicas, self.config.n_chains
        if c == 1:
            pt = init_replicas(self.system, r, key)
        else:
            pt = stack_leaves([init_replicas(self.system, r, keys.fold_in(key, i))
                               for i in range(c)])
        stats = stats_lib.init_stats(r, self._names, device, self._chain_axis())
        return EngineState(pt=pt, stats=stats, betas=_betas(temps, device))

    def restore(self, checkpoint):
        """``(EngineState, meta)`` of the newest restorable step of a
        `repro_torch.checkpoint.CheckpointManager` on the engine's device, or
        None when it holds no step.  The shape template is built on the
        ``meta`` device: no system init runs."""
        meta_dev = torch.device("meta")
        template = self._fresh_state(keys.key(0, device=meta_dev),
                                     np.ones(self.config.n_replicas), meta_dev)
        return checkpoint.restore_latest(template, device=self.device)

    def _require_on_device(self, state: EngineState) -> None:
        """Raise unless every tensor of ``state`` is on the engine's device.

        The kernels dispatch on the tensors' device, so a CPU state given to
        a CUDA engine would otherwise run the plain path on the CPU.
        """
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        for name, x in _state_tensors(state):
            if x.device != want:
                raise ValueError(
                    f"state tensor {name} is on {x.device} but the engine runs "
                    f"on {want}; build the state on the engine's device"
                )

    def reset_stats(self, state: EngineState) -> EngineState:
        """Zero the accumulators; flow labels are chain state and survive."""
        self._require_on_device(state)
        stats = stats_lib.init_stats(self.config.n_replicas, self._names, self.device,
                                     self._chain_axis())
        stats.direction = state.stats.direction
        if self._adapt_state is not None:
            self._adapt_state.zero()
        return dataclasses.replace(state, stats=stats)

    def _advance_chain(self, pt_st: PTState, stats, betas, n_intervals: int):
        """``n_intervals`` intervals of one chain; device work only."""
        cfg = self.config
        recs = []
        for _ in range(n_intervals):
            pt_st, rec = self._step(pt_st, betas)
            if cfg.track_stats:
                stats = stats_lib.update_stats(stats, rec, pt_st.rung)
            if cfg.record_trace:
                recs.append(rec)
        trace = {k: torch.stack([r[k] for r in recs]) for k in recs[0]} if recs else None
        return pt_st, stats, trace

    def advance(self, state: EngineState, n_intervals: int):
        """``n_intervals`` intervals of every chain: what `run` issues between
        two chunk boundaries, with no host sync.

        Returns ``(state', trace)``; ``trace`` maps each record series to a
        ``(T, R)`` tensor (``(C, T, R)`` with an ensemble) when
        ``record_trace`` is on, else None.
        """
        if self.config.n_chains == 1:
            pt_st, stats, trace = self._advance_chain(
                state.pt, state.stats, state.betas, n_intervals)
            return EngineState(pt=pt_st, stats=stats, betas=state.betas), trace
        outs = [
            self._advance_chain(map_leaves(state.pt, lambda x: x[c]),
                                map_leaves(state.stats, lambda x: x[c]),
                                state.betas, n_intervals)
            for c in range(self.config.n_chains)
        ]
        trace = None
        if outs[0][2] is not None:
            trace = {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]}
        state = EngineState(pt=stack_leaves([o[0] for o in outs]),
                            stats=stack_leaves([o[1] for o in outs]),
                            betas=state.betas)
        return state, trace

    def run(
        self,
        state: EngineState,
        n_sweeps: int,
        *,
        on_chunk: Callable[[ChunkInfo], Any] | None = None,
        on_adapt: Callable[[AdaptInfo], Any] | None = None,
        keep_trace: bool = True,
    ) -> tuple[EngineState, RunResult]:
        """Advance ``n_sweeps`` sweeps (per chain) in chunks of
        ``chunk_intervals`` intervals.

        Between chunks the host feeds the measured counters to the ladder
        feedback when ``adapt`` is set, and calls ``on_chunk`` (truthy return
        stops the run; `repro_torch.api.CheckpointCallback` saves there).
        ``n_sweeps`` must be a multiple of the interval.
        """
        self._require_on_device(state)
        cfg = self.config
        spi = cfg.spec.sweeps_per_interval
        if n_sweeps % spi != 0:
            raise ValueError(
                f"n_sweeps={n_sweeps} not a multiple of the interval ({spi} sweeps)"
            )
        n_intervals = n_sweeps // spi
        temps = self._temps
        if temps is None or not np.array_equal(
            state.betas.cpu().numpy(), (1.0 / temps).astype(np.float32)
        ):
            temps = 1.0 / state.betas.cpu().numpy().astype(np.float64)
        ladder_history = [temps.astype(np.float32)]
        adapt_st = self._adapt_state
        if adapt_st is None:
            adapt_st = AdaptState.fresh(cfg.n_replicas)
            if self.adapt is not None:
                adapt_st.rebase(_counters(state))
        adapt_st.rounds = self._adapt_rounds
        if self.adapt is not None:
            self._adapt_state = adapt_st
        chunks: list[dict[str, np.ndarray]] = []
        done = chunk_idx = 0
        stopped = False
        while done < n_intervals:
            this = min(cfg.chunk_intervals, n_intervals - done)
            state, trace = self.advance(state, this)
            done += this
            chunk_idx += 1
            chunk_np = None
            if trace is not None:
                chunk_np = {k: v.cpu().numpy() for k, v in trace.items()}
                if keep_trace:
                    chunks.append(chunk_np)
            if self.adapt is not None and done < n_intervals:
                new_temps, acceptance = maybe_adapt(
                    temps, _counters(state), self.adapt, adapt_st
                )
                if new_temps is not None:
                    temps = np.asarray(new_temps, np.float64)
                    self._temps = temps
                    ladder_history.append(temps.astype(np.float32))
                    self._adapt_rounds = adapt_st.rounds
                    # moments restart at a retune: never pool two ladders
                    st = state.stats
                    stats = dataclasses.replace(
                        st,
                        n_records=torch.zeros_like(st.n_records),
                        weight_sum=torch.zeros_like(st.weight_sum),
                        mean={k: torch.zeros_like(v) for k, v in st.mean.items()},
                        m2={k: torch.zeros_like(v) for k, v in st.m2.items()},
                    )
                    state = EngineState(
                        pt=state.pt, stats=stats, betas=_betas(temps, self.device)
                    )
                    if on_adapt is not None:
                        on_adapt(AdaptInfo(
                            round=adapt_st.rounds,
                            temps=temps.astype(np.float32).copy(),
                            acceptance=np.asarray(acceptance, np.float64),
                            sweeps_done=done * spi,
                        ))
            if on_chunk is not None and on_chunk(ChunkInfo(
                index=chunk_idx, sweeps_done=done * spi, n_sweeps=n_sweeps,
                state=state, trace=chunk_np,
            )):
                stopped = True
                break
        trace_out = None
        if chunks:
            axis = 1 if cfg.n_chains > 1 else 0  # chain-first (C, T, R)
            trace_out = {k: np.concatenate([c[k] for c in chunks], axis=axis)
                         for k in chunks[0]}
        result = RunResult(
            summary=stats_lib.summarize(state.stats),
            trace=trace_out,
            ladder_history=np.stack(ladder_history),
            n_sweeps=done * spi,
            stopped_early=stopped,
        )
        return state, result
