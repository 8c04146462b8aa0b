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
``(C, R, ...)``; chain ``c`` is seeded from ``fold_in(key, c)`` (`init`),
or from a key of its own (`init_ensemble`, the serve layer's packing hook),
so its trajectory does not depend on C.  Where JAX ``vmap``s the chunk over
the chains, the round and fused paths pass the whole stacked state to one
kernel call per interval (`make_ensemble_step`): one launch a round (or an
interval) for every chain on CUDA, its grid's second dimension the chain.
The exchange strategy's swap phase (fused path) and the observables then
run chain by chain on their slices, so each chain's reductions are those of
a solo run, and the accumulators update once for all chains.  The
per-sweep path (and a recycling strategy, VMPT) runs each chain's chunk in
turn on its slice of the stacked state (a host loop: C launches of each
kernel per sweep) and stacks the results at the chunk's end.  No path
waits for the card between chunk boundaries.

Observability and faults (`repro_torch.obs`, `repro_torch.resilience`)
hook the host loop as in the JAX engine: every site is one ``is None``
test when off, and the kernel launches are the same with them on or off.
A chunk is *prepared* once per chunk length (the path's kernel libraries
built and loaded: the JAX engine's compile, counted in ``n_compiles``).  A
failed preparation or a refused launch on a fused or round path degrades
the engine to the per-sweep path on the card (``strict_kernels`` and a
mesh make it an error); nothing falls back to the CPU or to a plain
version.

`Engine.restore` reads the newest checkpoint of a
`repro_torch.checkpoint.CheckpointManager` onto the engine's device, and
``Engine.run(checkpoint=, checkpoint_every_chunks=)`` saves one every N
chunks in the JAX package's format.

On a mesh (``EngineConfig.mesh``, a `repro_torch.core.distributed.MeshSpec`)
the engine is one rank of a `torch.distributed` process group and holds its
block of the state (`core.distributed.local_block`).  Each interval runs
`make_sharded_interval_step`, the twin of the JAX engine's ``shard_map``
body: the rank's block sweeps with global slot ids (``replica_offset``
into the fused kernels' counter streams and into the per-sweep keys), the
(R,) energy and rung rows are all-gathered over the replica subgroup, the
full-ladder exchange is computed on every rank from identical rows (on the
round path by the standalone exchange launch, `kernels.exchange.
exchange_rows`, from the round kernel's own swap stream), each rank keeps
its block of the new rungs, and the observables are evaluated on the local
lattices and gathered as O(R) rows.  Lattices never cross ranks in temp
mode.  Records, accumulators and `RunResult` are whole rows, equal on every
rank; checkpoints gather the whole state to rank 0, which writes it, and
any mesh restores any checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as dist_lib
from repro_torch.core import keys
from repro_torch.core.distributed import MeshSpec
from repro_torch.core.pt import PTState, init_replicas, map_states, stack_states
from repro_torch.device import resolve_device
from repro_torch.engine import stats as stats_lib
from repro_torch.engine.adapt import AdaptConfig, AdaptState, maybe_adapt
from repro_torch.engine.stats import map_leaves, stack_leaves
from repro_torch.exchange import DEO, ExchangeStrategy, make_strategy
from repro_torch.kernels import build
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
    "make_ensemble_step",
    "make_sharded_interval_step",
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


def _observe(observables, st: PTState, gather=None) -> dict[str, torch.Tensor]:
    """Per-rung series in rung order (cold→hot).  On a mesh ``st`` holds the
    rank's block of lattices beside the whole (R,) energy and rung rows;
    each observable is evaluated on the local lattices and its row
    all-gathered (``gather``), so lattices never cross ranks."""
    inv = _inverse(st.rung)
    out = {"energy": st.energy[inv]}
    for name, fn in observables.items():
        v = fn(st.states)
        out[name] = (v if gather is None else gather(v))[inv]
    return out


def _observe_chains(observables, st: PTState, gather=None) -> dict[str, torch.Tensor]:
    """`_observe` chain by chain on C stacked chains: ``(C, R)`` records."""
    return _stack_records([_observe(observables, _chain(st, c), gather)
                           for c in range(st.rung.shape[0])])


def _chain(st: PTState, c: int) -> PTState:
    """Chain ``c`` of a stacked state: views of its slices, no copy."""
    return PTState(states=map_states(st.states, lambda x: x[c]), energy=st.energy[c],
                   rung=st.rung[c], key=st.key[c], phase=st.phase[c], t=st.t[c])


def _stack_records(recs: list[dict]) -> dict[str, torch.Tensor]:
    return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}


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


def _interval_parts(system, spec: StepSpec, observables, layout=None):
    """``(sweeps, exchange)``: an interval's S sweeps without the exchange,
    and its swap phase and record after them, on the per-sweep or the
    interval-fused path (``sweeps`` also takes stacked chains there).

    ``exchange(st, betas, rows=None)`` returns ``(st', record, rung)`` with
    ``rung`` the whole post-swap slot→rung map.  On a mesh (``layout``)
    ``st`` is the rank's block: the sweeps key its slots by their global
    ids (``replica_offset = d * R/D``: the fused kernels' counter stream,
    the per-sweep keys ``fold_in(fold_in(key, 2t), offset + r)``), and
    ``rows`` are the gathered (R,) energy and rung rows, on which the
    decision runs for the full ladder before the rank keeps its block."""
    fused = getattr(system, "use_fused", False)
    recycle = spec.do_swap and spec.exchange.n_virtual > 1
    spi = spec.sweeps_per_interval
    kw, gather = {}, None
    if layout is not None:
        start, stop = layout.slot_block(spec.n_replicas)
        kw = {"replica_offset": start}

        def gather(x):
            # looked up at each call: a caller may wrap the layout's collective
            return layout.gather_replicas(x)

    def sweeps(st: PTState, betas: torch.Tensor) -> PTState:
        """The interval's S sweeps, without the exchange."""
        betas_slot = betas[st.rung.long()]
        if fused:
            states, de, _ = system.batched_mcmc_interval(
                st.key, st.t, st.states, betas_slot, n_sweeps=spi, **kw
            )
            return dataclasses.replace(
                st, states=states, energy=st.energy + de, t=st.t + spi
            )
        for _ in range(spi):
            # JAX's _sweep_once: energy and t advance after every sweep
            states, de, _ = system.batched_mcmc_step(st.key, st.t, st.states, betas_slot, **kw)
            st = dataclasses.replace(
                st, states=states, energy=st.energy + de, t=st.t + 1
            )
        return st

    def exchange(st: PTState, betas: torch.Tensor, rows=None):
        """The interval's swap phase and record, after its sweeps."""
        # on a mesh: the local lattices beside the whole rows (in state mode
        # the mesh has one slot block, EngineConfig's guard: the rank's own)
        full = st if rows is None else dataclasses.replace(st, energy=rows[0], rung=rows[1])
        if recycle:
            # both outcomes of every attempted pair, pre-swap, in rung order
            partner, perm, diag = _swap_decision(spec, betas, full)
            pre = _observe(observables, full, gather)
            rec = {k: torch.stack([v, v[partner]]) for k, v in pre.items()}
            rec["est_weight"] = spec.exchange.estimator_weights(partner, diag["swap_prob"])
            full = _apply_swap(spec, full, perm)
        else:
            if spec.do_swap:
                _, perm, diag = _swap_decision(spec, betas, full)
                full = _apply_swap(spec, full, perm)
            else:
                z = torch.zeros(spec.n_replicas, device=st.energy.device)
                diag = {"swap_accept": z.bool(), "swap_prob": z, "swap_attempt": z.bool()}
            rec = _observe(observables, full, gather)
        rec.update(diag)
        if rows is None:
            return full, rec, full.rung
        block = dataclasses.replace(full, energy=full.energy[start:stop],
                                    rung=full.rung[start:stop])
        return block, rec, full.rung

    return sweeps, exchange


def _exchange_chains(spec: StepSpec, exchange, st: PTState, betas, rows=None):
    """Each chain's swap phase (`_interval_parts`' ``exchange``) on its
    slice of C stacked chains, ``rows`` the gathered (C, R) energy and rung
    rows on a mesh: ``(st', (C, R) records, (C, R) rungs)``."""
    outs = [exchange(_chain(st, c), betas, None if rows is None else (rows[0][c], rows[1][c]))
            for c in range(st.rung.shape[0])]
    chains = [o[0] for o in outs]
    # temp mode moves no state: the stacked lattices stand as they are
    states = (st.states if spec.swap_mode == "temp"
              else stack_states([c.states for c in chains]))
    st = PTState(states=states,
                 **{f: torch.stack([getattr(c, f) for c in chains])
                    for f in ("energy", "rung", "key", "phase", "t")})
    return st, _stack_records([o[1] for o in outs]), torch.stack([o[2] for o in outs])


def make_interval_step(system, spec: StepSpec, observables=None):
    """Build ``(PTState, betas) -> (PTState, record)`` for one interval.

    ``record`` holds per-rung ``energy``, each observable, and
    ``swap_accept``/``swap_prob``/``swap_attempt`` at the lower rung of
    each attempted pair.  With a waste-recycling strategy the series are
    the pre-swap values of both outcomes, ``(2, R)``, beside ``est_weight``.
    """
    observables = dict(observables or {})
    fused_round = _round_interval(system, spec)
    sweeps, exchange = _interval_parts(system, spec, observables)
    spi = spec.sweeps_per_interval

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
        return exchange(sweeps(st, betas), betas)[:2]

    return interval_step


def _stacks_chains(system, spec: StepSpec) -> bool:
    """Whether an interval of C stacked chains is one kernel call: the round
    and interval-fused paths (their kernels take a chain axis), unless the
    strategy recycles (VMPT's record is one chain's)."""
    if _round_interval(system, spec) is None and not getattr(system, "use_fused", False):
        return False
    return not (spec.do_swap and spec.exchange.n_virtual > 1)


def make_ensemble_step(system, spec: StepSpec, observables=None):
    """``(PTState, betas) -> (PTState, record)`` for one interval of C
    stacked chains, on the paths whose kernels take a chain axis: the whole
    round (one kernel call for every chain, one launch a round on CUDA) and
    the interval-fused sweeps (one call for every chain, then each chain's
    swap phase on its slice).  The observables reduce chain by chain on
    their slices, so every chain's record is its solo run's.  Records are
    ``(C, R)``.  None for the paths that run chain by chain (per sweep, and
    a recycling strategy)."""
    observables = dict(observables or {})
    if not _stacks_chains(system, spec):
        return None
    fused_round = _round_interval(system, spec)
    spi = spec.sweeps_per_interval
    sweeps, exchange = _interval_parts(system, spec, observables)

    def ensemble_step(st: PTState, betas: torch.Tensor):
        if fused_round is not None:
            states, rung, energy, _, acc, prob, att = fused_round(
                st.key, st.t, st.phase, st.states, st.rung, st.energy, betas,
                n_sweeps=spi, criterion=spec.criterion, pairing=spec.exchange.name,
            )
            st = dataclasses.replace(st, states=states, rung=rung, energy=energy,
                                     t=st.t + spi, phase=st.phase + 1)
            rec = _observe_chains(observables, st)
            rec.update(swap_accept=acc[0], swap_prob=prob[0], swap_attempt=att[0])
            return st, rec
        return _exchange_chains(spec, exchange, sweeps(st, betas), betas)[:2]

    return ensemble_step


# -- sharded interval step: one rank's block of a mesh --------------------------


def make_sharded_interval_step(system, spec: StepSpec, observables, layout):
    """``step(st_local, betas) -> (st_local, record, rung_full)`` for one
    interval of a rank's block (twin of the JAX engine's
    ``make_sharded_interval_step``).

    ``st_local`` is one chain's block (``(R/D, ...)`` leaves) or, on the
    round and interval-fused paths, the rank's chains stacked (``(C/E,
    R/D, ...)``, one kernel call an interval for all of them).  Same record
    contract and PRNG streams as `make_interval_step`: the sweeps and the
    strategies' exchange are `_interval_parts` on the rank's block, after
    one all-gather each of the energy and rung rows over the replica
    subgroup (`MeshLayout.gather_replicas`).  The round path runs its
    exchange as one standalone launch over the rank's chains
    (`kernels.exchange.exchange_rows`) from the round kernel's counter swap
    stream, so a sharded round run equals the single-device round launch;
    the same launch writes the rank's block of the new rungs and the next
    phase, so on the card nothing else runs between the gathers and the
    observables.

    ``record`` holds whole (R,) rows in rung order (``(C/E, R)`` stacked)
    and ``rung_full`` is the post-swap slot→rung map the stats update keys
    on.
    """
    observables = dict(observables or {})
    fused_round = _round_interval(system, spec) is not None
    sweeps, exchange = _interval_parts(system, spec, observables, layout)
    start, stop = layout.slot_block(spec.n_replicas)

    def gather(x):
        # looked up at each call: a caller may wrap the layout's collective
        return layout.gather_replicas(x)

    def step(st: PTState, betas: torch.Tensor):
        stacked = st.key.dim() == 2
        st = sweeps(st, betas)
        # the exchange's only traffic: the O(R) energy and rung rows
        rows = gather(st.energy), gather(st.rung)
        if not fused_round:
            if stacked:
                return _exchange_chains(spec, exchange, st, betas, rows)
            return exchange(st, betas, rows)
        # one launch on the card: the decisions, the rank's block of the new
        # rungs and the next phase
        new_rung, acc, prob, att, rung, phase = kernel_exchange.exchange_rows(
            rows[1], rows[0], betas, st.phase, st.key, pairing=spec.exchange.name,
            criterion=spec.criterion, block=(start, stop))
        st = dataclasses.replace(st, rung=rung, phase=phase)
        full = dataclasses.replace(st, energy=rows[0], rung=new_rung)
        rec = (_observe_chains(observables, full, gather) if stacked
               else _observe(observables, full, gather))
        rec.update(swap_accept=acc, swap_prob=prob, swap_attempt=att)
        return st, rec, new_rung

    return step


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration (see `repro.engine.EngineConfig`).

    ``donate`` is accepted for spec compatibility; PyTorch has no buffer
    donation and the engine simply rebinds its state tensors.  ``mesh`` (a
    `MeshSpec` or its dict form) runs the engine as one rank of a mesh;
    it must divide the run (``n_chains % ensemble == 0``, ``n_replicas %
    replica == 0``), and a sharded replica axis needs ``swap_mode='temp'``.
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
        if self.swap_mode not in ("temp", "state"):
            raise ValueError(f"bad swap_mode {self.swap_mode!r}")
        object.__setattr__(self, "exchange", make_strategy(self.exchange))
        if isinstance(self.mesh, Mapping):
            object.__setattr__(self, "mesh", MeshSpec(**self.mesh))
        if self.mesh is not None:
            self.mesh.validate(self.n_replicas, self.n_chains)
            if self.mesh.replica > 1 and self.swap_mode != "temp":
                raise ValueError(
                    "swap_mode='state' exchanges O(R*L^2) lattice state and "
                    "is not supported across a sharded replica axis; use "
                    "swap_mode='temp' or mesh.replica=1"
                )

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


# -- observability (obs-on runs only; see repro_torch.obs) ----------------------


def _lattice_cells(system) -> int | None:
    """Sites of one lattice (Ising ``length``², Potts ``shape``), else None."""
    length = getattr(system, "length", None)
    if length is not None:
        return int(length) * int(length)
    shape = getattr(system, "shape", None)
    if isinstance(shape, tuple) and len(shape) == 2:
        return int(shape[0]) * int(shape[1])
    return None


class _EngineObs:
    """Pre-resolved metric handles + timeline for an instrumented engine.

    Built once when an `repro_torch.obs.Observability` is attached
    (``engine.obs = obs``), never on the obs-off path.  Every series comes
    from what the engine holds on the host anyway (the O(R) pooled counters,
    wall-clock timestamps, preparation bookkeeping); the only device
    interaction is the one synchronisation a chunk that ``device_seconds``
    needs.  The metric names and help strings are the JAX engine's.
    """

    __slots__ = (
        "obs", "timeline", "compiles", "compile_seconds", "chunks", "sweeps",
        "chunk_seconds", "device_seconds", "host_seconds", "sweeps_per_sec",
        "swap_acc", "flow_up", "adapt_rounds", "checkpoints", "hbm_bytes",
        "degraded_kernel", "_last_counters",
    )

    def __init__(self, obs, system, config):
        self.obs = obs
        self.timeline = obs.timeline
        m = obs.metrics
        self.compiles = m.counter(
            "engine_compiles_total", "mega-step AOT compiles")
        self.compile_seconds = m.counter(
            "engine_compile_seconds_total", "wall seconds spent in AOT compile")
        self.chunks = m.counter(
            "engine_chunks_total", "compiled chunks executed")
        self.sweeps = m.counter(
            "engine_sweeps_total", "sweeps advanced (per chain)")
        self.chunk_seconds = m.histogram(
            "engine_chunk_seconds", "wall time per compiled chunk")
        self.device_seconds = m.counter(
            "engine_device_seconds_total",
            "wall seconds waiting on device inside chunks")
        self.host_seconds = m.counter(
            "engine_host_seconds_total",
            "host-side overhead between device launches (adapt, trace drain, "
            "checkpoint, callbacks)")
        self.sweeps_per_sec = m.gauge(
            "engine_sweeps_per_sec", "throughput of the last chunk")
        self.adapt_rounds = m.counter(
            "engine_adapt_rounds_total", "ladder retunes performed")
        self.checkpoints = m.counter(
            "engine_checkpoints_total", "engine-loop checkpoint saves")
        self.degraded_kernel = m.counter(
            "pt_degraded_kernel",
            "fused/Pallas compile failures degraded to the per-sweep path")
        acc = m.gauge("pt_swap_acceptance",
                      "live swap acceptance per rung pair", labels=("pair",))
        flow = m.gauge("pt_flow_up_fraction",
                       "live up-flow fraction f(k) per rung", labels=("rung",))
        self.swap_acc = [acc.labels(str(k)) for k in range(config.n_replicas - 1)]
        self.flow_up = [flow.labels(str(k)) for k in range(config.n_replicas)]
        # window deltas for the acceptance gauges
        self._last_counters = None
        self.hbm_bytes = self._modeled_hbm_bytes(system, config)

    @staticmethod
    def _modeled_hbm_bytes(system, config) -> float | None:
        """Modeled device-memory bytes of one chunk of the port's kernels.

        The round and fused paths (kernels A, #2p, #5) draw their uniforms
        in the kernel: a launch reads and writes each int8 lattice once,
        2 B a site, one launch an interval.  The per-sweep path writes its
        uniform planes (``jax_uniform``: 2 f32 planes a site for Ising, 4
        for Potts) and the sweep (#1, #4) reads them and reads and writes
        the lattice, every sweep.  The O(R) rows are left out.  None for a
        system without a lattice (nothing rather than a wrong number).
        """
        cells = _lattice_cells(system)
        if cells is None:
            return None
        per_site = 2.0 if getattr(system, "use_fused", False) else None
        launches = config.chunk_intervals
        if per_site is None:
            planes = 4 if hasattr(system, "q") else 2
            per_site = 2 * 4.0 * planes + 2.0
            launches *= config.spec.sweeps_per_interval
        return per_site * cells * launches * config.n_replicas * config.n_chains

    def record_chunk(self, *, intervals, spi, device_s, wall_s) -> None:
        """Per-chunk series: throughput and durations."""
        sweeps = intervals * spi
        self.chunks.inc()
        self.sweeps.inc(sweeps)
        self.chunk_seconds.observe(wall_s)
        self.device_seconds.inc(device_s)
        self.host_seconds.inc(max(wall_s - device_s, 0.0))
        if wall_s > 0:
            self.sweeps_per_sec.set(sweeps / wall_s)

    def record_rungs(self, counters: dict[str, np.ndarray]) -> None:
        """Refresh the per-rung gauges from this chunk's counter deltas."""
        last = self._last_counters
        self._last_counters = counters
        if last is not None:
            att = counters["attempts"] - last["attempts"]
            acc = counters["accepts"] - last["accepts"]
        else:
            att, acc = counters["attempts"], counters["accepts"]
        for k, g in enumerate(self.swap_acc):
            if att[k] > 0:
                g.set(acc[k] / att[k])
        lab = counters["labeled"]
        up = counters["up"]
        for k, g in enumerate(self.flow_up):
            if lab[k] > 0:
                g.set(up[k] / lab[k])


# the kernel flags whose paths degrade to the per-sweep path
_KERNEL_FLAGS = ("use_fused_round", "use_fused", "pack_bits")


class Engine:
    """Chunked PT driver over a `System` on one device, or one rank of a mesh.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels.  On a mesh (``config.mesh``) the
    engine binds to the running process group (`MeshSpec.build`): its
    states are the rank's block, ``cuda`` means ``cuda:{LOCAL_RANK}``.
    ``obs`` (`repro_torch.obs.Observability`) and ``faults``
    (`repro_torch.resilience.FaultPlan`) instrument the host loop;
    ``strict_kernels`` makes a failed kernel preparation or launch on a
    fused or round path an error instead of a degradation to the per-sweep
    path (which calls ``on_degrade``); on a mesh it is always an error.
    """

    def __init__(
        self,
        system,
        config: EngineConfig,
        observables: Mapping[str, Callable] | None = None,
        adapt: AdaptConfig | None = None,
        device="cuda",
        obs=None,
        faults=None,
        strict_kernels: bool = False,
        on_degrade: Callable[[], Any] | None = None,
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
        # the rank's place on the mesh is engine state, not config: MeshSpec
        # is pure shape (serializable through RunSpec), build() binds ranks
        self.layout = None if config.mesh is None else config.mesh.build(device)
        self.device = resolve_device(device) if self.layout is None else self.layout.device
        self._build_steps()
        self._names = ["energy"] + sorted(self.observables)
        self._adapt_rounds = 0
        self._adapt_state: AdaptState | None = None
        # the authoritative f64 ladder behind the f32 betas
        self._temps: np.ndarray | None = None
        # chunk lengths prepared (the path's kernels built and loaded), and
        # how many preparations this engine made: the serve layer's "one
        # engine per bucket shape" is pinned on this count
        self._prepared: set[int] = set()
        self.n_compiles = 0
        # observability handle: None keeps every site one `is None` test
        self._eobs: _EngineObs | None = None
        if obs is not None:
            self.obs = obs
        # fault-injection handle: the same zero-cost-off contract
        self._faults = faults
        self.strict_kernels = strict_kernels
        self._on_degrade = on_degrade
        self._degraded = False

    def _build_steps(self) -> None:
        """The interval steps, each ``(st, betas) -> (st, record, rung)``
        with ``rung`` the whole post-swap slot→rung map the stats key on."""
        spec = self.config.spec
        if self.layout is not None:
            step = make_sharded_interval_step(self.system, spec, self.observables,
                                              self.layout)
            self._step = step
            # the stacked chains take one kernel call an interval where the
            # path's kernels have a chain axis; else chain by chain
            stacked = self.config.n_chains > 1 and _stacks_chains(self.system, spec)
            self._ensemble_step = step if stacked else None
            return

        def with_rung(fn):
            def run(st, betas):
                st, rec = fn(st, betas)
                return st, rec, st.rung
            return run

        self._step = with_rung(make_interval_step(self.system, spec, self.observables))
        ens = (make_ensemble_step(self.system, spec, self.observables)
               if self.config.n_chains > 1 else None)
        self._ensemble_step = None if ens is None else with_rung(ens)

    @property
    def obs(self):
        """The attached `repro_torch.obs.Observability`, or None (obs off)."""
        return self._eobs.obs if self._eobs is not None else None

    @obs.setter
    def obs(self, value):
        # metric handles resolve once here, not per chunk
        self._eobs = None if value is None else _EngineObs(value, self.system, self.config)

    def _chain_axis(self) -> int:
        """The chains this rank's accumulators hold, for `stats.init_stats`:
        0 means no ensemble axis."""
        c = self.config.n_chains
        if c == 1:
            return 0
        return c if self.layout is None else c // self.layout.spec.ensemble

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and results (rank 0 of a
        mesh; always off a mesh)."""
        return self.layout is None or self.layout.is_writer

    def gathered(self, state: EngineState) -> EngineState:
        """The whole engine state (every rank's block gathered, on every
        rank; `core.distributed.gather_state`); ``state`` itself off a
        mesh.  A collective: every rank of the mesh calls it."""
        if self.layout is None:
            return state
        return dist_lib.gather_state(state, self.layout)

    def local(self, state: EngineState) -> EngineState:
        """This rank's block of a whole engine state (``state`` itself off a
        mesh)."""
        if self.layout is None:
            return state
        return dist_lib.local_block(state, self.layout.spec, self.layout.coords)

    def _full_stats(self, stats):
        """The accumulators of every chain (gathered over the ensemble
        subgroup on a mesh; rows are whole on every rank already)."""
        if self.layout is None or self.config.n_chains == 1:
            return stats
        return map_leaves(stats, self.layout.gather_chains)

    def _check_ladder(self, temps) -> np.ndarray:
        temps = np.asarray(temps, np.float64)
        if temps.shape != (self.config.n_replicas,):
            raise ValueError(
                f"ladder shape {temps.shape} != (n_replicas={self.config.n_replicas},)"
            )
        self._temps = temps.copy()
        self._adapt_state = None
        return temps

    def init(self, key: torch.Tensor, temps) -> EngineState:
        """Fresh state on the given ladder from a (2,) key.

        One chain starts from ``key`` itself; with an ensemble, chain ``c``
        starts from ``fold_in(key, c)``.
        """
        temps = self._check_ladder(temps)
        return self.local(self._fresh_state(key.to(self.device), temps, self.device))

    def init_ensemble(self, keys_: Sequence[torch.Tensor], temps) -> EngineState:
        """Fresh state where chain ``c`` starts from ``keys_[c]`` verbatim.

        The packing hook of `repro_torch.serve`: a bucket hands each chain
        the key its solo ``n_chains=1`` run starts from (``keys.key(seed)``),
        so every packed chain's trajectory is its solo run's.  The chains'
        states are built one at a time and stacked, each exactly as `init`
        builds one chain.  ``len(keys_)`` must equal ``config.n_chains``.
        """
        c = self.config.n_chains
        if len(keys_) != c:
            raise ValueError(f"init_ensemble got {len(keys_)} keys != n_chains={c}")
        temps = self._check_ladder(temps)
        r = self.config.n_replicas
        per_chain = [init_replicas(self.system, r, k.to(self.device)) for k in keys_]
        pt = per_chain[0] if c == 1 else stack_leaves(per_chain)
        stats = stats_lib.init_stats(r, self._names, self.device, 0 if c == 1 else c)
        return self.local(EngineState(pt=pt, stats=stats, betas=_betas(temps, self.device)))

    def _fresh_state(self, key, temps, device) -> EngineState:
        r, c = self.config.n_replicas, self.config.n_chains
        if c == 1:
            pt = init_replicas(self.system, r, key)
        else:
            pt = stack_leaves([init_replicas(self.system, r, keys.fold_in(key, i))
                               for i in range(c)])
        stats = stats_lib.init_stats(r, self._names, device, 0 if c == 1 else c)
        return EngineState(pt=pt, stats=stats, betas=_betas(temps, device))

    def restore(self, checkpoint):
        """``(EngineState, meta)`` of the newest restorable step of a
        `repro_torch.checkpoint.CheckpointManager` on the engine's device, or
        None when it holds no step.  The shape template is built on the
        ``meta`` device: no system init runs.  Checkpoints hold the whole
        state, so on a mesh every rank reads the file and keeps its block,
        whatever mesh (or package) wrote it."""
        meta_dev = torch.device("meta")
        template = self._fresh_state(keys.key(0, device=meta_dev),
                                     np.ones(self.config.n_replicas), meta_dev)
        out = checkpoint.restore_latest(template, device=self.device)
        if out is None:
            return None
        state, meta = out
        return self.local(state), meta

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

    # -- chunk preparation and kernel degradation --------------------------------
    def ensure_compiled(self, chunk_len: int) -> None:
        """Prepare a chunk of ``chunk_len`` intervals, once per length: on
        CUDA, build and load the kernel libraries the path launches (the JAX
        engine's AOT compile, counted in ``n_compiles``).  A failure there,
        or an injected ``engine.compile`` fault, degrades a fused or round
        path (`_degrade`)."""
        if chunk_len in self._prepared:
            return
        eo = self._eobs
        t0 = time.perf_counter() if eo is not None else 0.0
        try:
            if self._faults is not None:
                self._faults.fire("engine.compile")
            if self.device.type == "cuda":
                build.load_all()
        except Exception as err:
            self._degrade(err)
            return self.ensure_compiled(chunk_len)
        self._prepared.add(chunk_len)
        self.n_compiles += 1
        if eo is not None:
            dt = time.perf_counter() - t0
            eo.compiles.inc()
            eo.compile_seconds.inc(dt)
            eo.timeline.complete(
                "compile", t0, dt, cat="compile",
                args={"chunk_intervals": chunk_len,
                      "n_replicas": self.config.n_replicas,
                      "n_chains": self.config.n_chains},
            )

    def _degrade(self, err: Exception) -> None:
        """Graceful kernel degradation: the per-sweep path, on the card.

        A failed kernel build, a refused launch on a fused or round path, or
        an injected ``engine.compile`` fault turns the system's kernel flags
        off: the engine then runs kernels #1/#4 and ``jax_uniform`` on the
        same device, bit-equal to a never-fused run of the same spec from
        the same state (the fused counter stream is not the per-sweep one).
        ``strict_kernels`` makes it an error, and so does a system with no
        kernel flag set (the serve Supervisor retries those).  So does a
        mesh: every rank must run the same path and swap stream, and a
        failure one rank meets cannot be agreed with the others mid-chunk.
        Never falls back to the CPU or to a plain version.
        """
        flags = [f for f in _KERNEL_FLAGS if getattr(self.system, f, False)]
        if self.strict_kernels or not flags or self._degraded or self.layout is not None:
            raise err
        self._degraded = True
        warnings.warn(
            f"kernel preparation or launch failed with {', '.join(flags)} "
            f"enabled ({err!r}); degrading to the per-sweep path on "
            f"{self.device} (statistically identical, not bit-equal to the "
            "fused stream).  Pass strict_kernels to make this fatal.",
            RuntimeWarning,
            stacklevel=3,
        )
        self.system = dataclasses.replace(self.system, **{f: False for f in flags})
        self._build_steps()
        self._prepared.clear()
        if self._eobs is not None:
            self._eobs.degraded_kernel.inc()
        if self._on_degrade is not None:
            self._on_degrade()

    # -- the interval loop -------------------------------------------------------
    def _advance_chain(self, pt_st: PTState, stats, betas, n_intervals: int):
        """``n_intervals`` intervals of one chain; device work only."""
        cfg = self.config
        recs = []
        for _ in range(n_intervals):
            pt_st, rec, rung = self._step(pt_st, betas)
            if cfg.track_stats:
                stats = stats_lib.update_stats(stats, rec, rung)
            if cfg.record_trace:
                recs.append(rec)
        trace = {k: torch.stack([r[k] for r in recs]) for k in recs[0]} if recs else None
        return pt_st, stats, trace

    def _advance_ensemble(self, state: EngineState, n_intervals: int):
        """``n_intervals`` intervals of the stacked chains, one kernel call an
        interval for all of them (`make_ensemble_step`)."""
        cfg = self.config
        pt_st, stats, recs = state.pt, state.stats, []
        for _ in range(n_intervals):
            pt_st, rec, rung = self._ensemble_step(pt_st, state.betas)
            if cfg.track_stats:
                stats = stats_lib.update_stats(stats, rec, rung)
            if cfg.record_trace:
                recs.append(rec)
        trace = ({k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}
                 if recs else None)
        return EngineState(pt=pt_st, stats=stats, betas=state.betas), trace

    def advance(self, state: EngineState, n_intervals: int):
        """``n_intervals`` intervals of every chain: what `run` issues between
        two chunk boundaries, with no host sync.

        Returns ``(state', trace)``; ``trace`` maps each record series to a
        ``(T, R)`` tensor (``(C, T, R)`` with an ensemble) when
        ``record_trace`` is on, else None.  A refused launch on a fused or
        round path degrades the engine (`_degrade`) and the chunk is issued
        again from ``state`` on the per-sweep path.
        """
        try:
            return self._issue(state, n_intervals)
        except build.KernelError as err:
            self._degrade(err)
            return self._issue(state, n_intervals)

    def _issue(self, state: EngineState, n_intervals: int):
        if self.config.n_chains == 1:
            pt_st, stats, trace = self._advance_chain(
                state.pt, state.stats, state.betas, n_intervals)
            return EngineState(pt=pt_st, stats=stats, betas=state.betas), trace
        if self._ensemble_step is not None:
            return self._advance_ensemble(state, n_intervals)
        outs = [
            self._advance_chain(map_leaves(state.pt, lambda x: x[c]),
                                map_leaves(state.stats, lambda x: x[c]),
                                state.betas, n_intervals)
            for c in range(state.pt.key.shape[0])
        ]
        trace = None
        if outs[0][2] is not None:
            trace = {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]}
        state = EngineState(pt=stack_leaves([o[0] for o in outs]),
                            stats=stack_leaves([o[1] for o in outs]),
                            betas=state.betas)
        return state, trace

    def _poison_energy(self, state: EngineState, chain: int) -> EngineState:
        """The ``engine.energy.nonfinite`` fault: one chain's energies NaN
        on the device (every chain's without an ensemble axis)."""
        e = state.pt.energy.clone()
        if e.dim() == 2:
            e[chain % e.shape[0]] = float("nan")
        else:
            e.fill_(float("nan"))
        return dataclasses.replace(state, pt=dataclasses.replace(state.pt, energy=e))

    def _pooled(self, state: EngineState) -> dict[str, np.ndarray]:
        """`_counters` of every chain (gathered over the mesh's ensemble
        subgroup), equal on every rank."""
        return _counters(dataclasses.replace(state, stats=self._full_stats(state.stats)))

    def save_checkpoint(self, checkpoint, state: EngineState, meta: dict) -> int:
        """Save ``state`` (the whole state: gathered to every rank on a
        mesh, then written by rank 0 alone) at its sweep counter, in the
        JAX package's format; returns the sweep.  Every rank calls it."""
        whole = self.gathered(state)
        sweep = int(whole.pt.t.reshape(-1)[0].item())
        if self.is_writer:
            checkpoint.save(sweep, whole, meta=meta)
        return sweep

    def run(
        self,
        state: EngineState,
        n_sweeps: int,
        *,
        checkpoint=None,
        checkpoint_every_chunks: int = 0,
        on_chunk: Callable[[ChunkInfo], Any] | None = None,
        on_adapt: Callable[[AdaptInfo], Any] | None = None,
        keep_trace: bool = True,
    ) -> tuple[EngineState, RunResult]:
        """Advance ``n_sweeps`` sweeps (per chain) in chunks of
        ``chunk_intervals`` intervals.

        Between chunks the host feeds the measured counters to the ladder
        feedback when ``adapt`` is set, saves the whole `EngineState` through
        ``checkpoint`` (a `repro_torch.checkpoint.CheckpointManager`) every
        ``checkpoint_every_chunks`` chunks and after the last (with the f64
        ladder and the adaptation window in the meta, as
        `repro_torch.api.CheckpointCallback` saves them), and calls
        ``on_chunk`` (truthy return stops the run).  ``n_sweeps`` must be a
        multiple of the interval.  With ``obs`` attached, each chunk is a
        span, and the host waits for the card at its end for an honest
        ``device_wait``.  On a mesh ``state`` is the rank's block and every
        rank runs this loop; the records, the trace and the result are the
        whole rows, equal on every rank.
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
                adapt_st.rebase(self._pooled(state))
        adapt_st.rounds = self._adapt_rounds
        if self.adapt is not None:
            self._adapt_state = adapt_st
        chunks: list[dict[str, np.ndarray]] = []
        done = chunk_idx = 0
        stopped = False
        eo = self._eobs
        while done < n_intervals:
            this = min(cfg.chunk_intervals, n_intervals - done)
            if self._faults is not None:
                f = self._faults.check("engine.chunk.stall")
                if f is not None:
                    time.sleep(f.duration)
                self._faults.fire("engine.chunk.launch")
            if eo is not None:
                t_chunk0 = time.perf_counter()
                self.ensure_compiled(this)
                profiling = eo.obs.start_torch_profile()
                t_launch = time.perf_counter()
                state, trace = self.advance(state, this)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                device_s = time.perf_counter() - t_launch
                if profiling:
                    eo.obs.stop_torch_profile()
            else:
                self.ensure_compiled(this)
                state, trace = self.advance(state, this)
            if self._faults is not None:
                f = self._faults.check("engine.energy.nonfinite")
                if f is not None:
                    state = self._poison_energy(state, f.chain)
            done += this
            chunk_idx += 1
            if eo is not None:
                eo.timeline.complete(
                    "device_wait", t_launch, device_s, cat="engine",
                    args={"chunk": chunk_idx, "intervals": this},
                )
            chunk_np = None
            if trace is not None:
                if self.layout is not None and cfg.n_chains > 1:
                    trace = {k: self.layout.gather_chains(v) for k, v in trace.items()}
                if eo is not None:
                    with eo.timeline.span("trace_drain", chunk=chunk_idx):
                        chunk_np = {k: v.cpu().numpy() for k, v in trace.items()}
                else:
                    chunk_np = {k: v.cpu().numpy() for k, v in trace.items()}
                if keep_trace:
                    chunks.append(chunk_np)
            if self.adapt is not None and done < n_intervals:
                t_adapt0 = time.perf_counter() if eo is not None else 0.0
                new_temps, acceptance = maybe_adapt(
                    temps, self._pooled(state), self.adapt, adapt_st
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
                if eo is not None:
                    eo.timeline.complete(
                        "adapt", t_adapt0, time.perf_counter() - t_adapt0,
                        cat="engine",
                        args={"retuned": new_temps is not None,
                              "round": adapt_st.rounds},
                    )
                    if new_temps is not None:
                        eo.adapt_rounds.inc()
            if (checkpoint is not None and checkpoint_every_chunks > 0
                    and (chunk_idx % checkpoint_every_chunks == 0 or done == n_intervals)):
                # the meta of repro_torch.api.CheckpointCallback: the exact
                # f64 ladder and the adaptation bookkeeping
                meta = {"temps": [float(t) for t in temps],
                        "adapt_rounds": self._adapt_rounds}
                if self._adapt_state is not None:
                    meta.update(self._adapt_state.to_meta())
                if eo is not None:
                    t_ck = time.perf_counter()
                    sweep = self.save_checkpoint(checkpoint, state, meta)
                    eo.timeline.complete("checkpoint", t_ck, time.perf_counter() - t_ck,
                                         cat="engine", args={"sweep": sweep})
                    eo.checkpoints.inc()
                else:
                    self.save_checkpoint(checkpoint, state, meta)
            if eo is not None:
                wall = time.perf_counter() - t_chunk0
                args = {"chunk": chunk_idx, "intervals": this,
                        "sweeps_done": done * spi}
                if eo.hbm_bytes is not None:
                    args["modeled_hbm_bytes"] = eo.hbm_bytes * this / cfg.chunk_intervals
                eo.timeline.complete("chunk", t_chunk0, wall, cat="engine", args=args)
                eo.record_chunk(intervals=this, spi=spi, device_s=device_s, wall_s=wall)
                if cfg.track_stats:
                    eo.record_rungs(self._pooled(state))
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
            summary=stats_lib.summarize(self._full_stats(state.stats)),
            trace=trace_out,
            ladder_history=np.stack(ladder_history),
            n_sweeps=done * spi,
            stopped_early=stopped,
        )
        return state, result
