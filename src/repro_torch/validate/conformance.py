"""Engine-vs-ground-truth conformance (twin of `repro.validate.conformance`).

`run_conformance` compiles one `repro_torch.core.systems.REGISTRY` entry to
a `RunSpec` (`entry_runspec`) and runs it through the port's production
path: `repro_torch.api.Session` over the chunked engine, adaptive ladder on,
ensemble axis on, with any registered exchange strategy (``exchange``: a
name or an `ExchangeSpec`; VMPT's means are its weighted ones), on the card
unless ``device="cpu"``.  Then it compares the energy and every registered
observable at every rung with the exact reference at the final adapted
ladder.

Schedule: a burn-in phase with ``adapt=True`` (all retunes fire there), then
``n_batches`` measurement phases of ``sweeps_per_batch`` sweeps, each with
``reset_stats=True``, so each chain x window Welford mean is one batch mean
(`repro_torch.validate.mcse`).  Verdict: ``z = (grand mean - exact) / MCSE``
per series and rung, and a first-half vs second-half Geweke drift score; a
retune during measurement raises.

`assert_conforms` is the gate: ``|mean - exact| <= z_max * MCSE + atol * (1
+ |exact|)`` and ``|geweke| <= geweke_max``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api import (
    AdaptSpec,
    Callback,
    EngineSpec,
    ExchangeSpec,
    LadderSpec,
    PhaseSpec,
    RunSpec,
    ScheduleSpec,
    Session,
    SystemSpec,
)
from repro_torch.core.systems import RegisteredSystem
from repro_torch.validate import exact as exact_lib
from repro_torch.validate.mcse import batch_mean_stats, effective_sample_size, geweke_z

__all__ = [
    "EXACT",
    "ConformanceReport",
    "entry_runspec",
    "run_conformance",
    "assert_conforms",
]

# Registry name -> exact-reference function (system, temps) -> {series: (R,)}.
EXACT = {
    "ising": exact_lib.ising_exact,
    "gaussian": exact_lib.gaussian_exact,
    "potts": exact_lib.potts_exact,
    "ea_spin_glass": exact_lib.ea_exact,
    "hp_protein": exact_lib.hp_exact,
}


@dataclasses.dataclass
class ConformanceReport:
    """Outcome of one conformance run (all arrays rung-ordered, cold→hot)."""

    name: str
    temps: np.ndarray  # final adapted ladder (R,)
    n_retunes: int  # ladder retunes that fired during burn-in
    means: dict[str, np.ndarray]  # engine grand means per series (R,)
    mcse: dict[str, np.ndarray]  # batch-means standard errors (R,)
    exact: dict[str, np.ndarray]  # ground truth at `temps` (R,)
    z: dict[str, np.ndarray]  # (means - exact) / mcse (R,)
    ess: dict[str, np.ndarray]  # implied effective sample size (R,)
    geweke: dict[str, np.ndarray]  # first-vs-second-half drift z (R,)
    n_batches: int  # chain x window batch count

    def worst(self) -> tuple[str, float]:
        """(series, max |z|): the closest-to-failing comparison."""
        name, val = "", 0.0
        for k, zk in self.z.items():
            m = float(np.abs(zk).max())
            if m >= val:
                name, val = k, m
        return name, val


def entry_runspec(
    entry: RegisteredSystem,
    seed: int = 0,
    exchange: str | ExchangeSpec | None = None,
    system_params: dict | None = None,
) -> RunSpec:
    """The `RunSpec` conformance executes for a zoo entry.

    One burn-in phase with the ladder feedback on, then ``n_batches``
    measurement phases (adapt stays on, capped by ``max_rounds``, so a
    too-thin burn trips the frozen-ladder check instead of skewing the
    reference).  ``system_params`` overlays the entry's constructor params:
    how kernel options such as ``use_fused_round`` + ``pack_bits`` join the
    gate.  ``python -m repro_torch run`` on its JSON runs the same simulation.
    """
    if exchange is None:
        exchange = ExchangeSpec()
    elif isinstance(exchange, str):
        exchange = ExchangeSpec(strategy=exchange)
    if entry.n_chains < 2:
        raise ValueError("conformance requires the ensemble axis (n_chains >= 2)")
    phases = [PhaseSpec(name="burn", n_sweeps=entry.burn_sweeps, adapt=True)]
    for b in range(entry.n_batches):
        phases.append(PhaseSpec(
            name=f"batch{b:02d}", n_sweeps=entry.sweeps_per_batch,
            adapt=True, reset_stats=True,
        ))
    return RunSpec(
        system=SystemSpec(
            name=entry.name, params={**entry.params, **(system_params or {})}
        ),
        ladder=LadderSpec(kind="custom", n_replicas=len(entry.temps), temps=entry.temps),
        engine=EngineSpec(
            swap_interval=entry.swap_interval,
            chunk_intervals=entry.chunk_intervals,
            n_chains=entry.n_chains,
        ),
        exchange=exchange,
        adapt=AdaptSpec(target=0.3, min_attempts_per_pair=10, max_rounds=entry.adapt_rounds),
        schedule=ScheduleSpec(phases=tuple(phases)),
        observables=entry.observable_names,
        seed=seed,
    )


def run_conformance(
    entry: RegisteredSystem,
    seed: int = 0,
    exact_fn=None,
    exchange=None,
    system_params: dict | None = None,
    device="cuda",
) -> ConformanceReport:
    """Run one zoo entry through the adaptive ensemble Session on ``device``
    and compare it with its exact reference."""
    if exact_fn is None:
        exact_fn = EXACT[entry.name]
    spec = entry_runspec(entry, seed=seed, exchange=exchange, system_params=system_params)
    frozen: dict[str, np.ndarray] = {}

    class _FreezeLadder(Callback):
        def on_phase_end(self, session, phase, result):
            if phase.name == "burn":
                frozen["betas"] = session.state.betas.cpu().numpy().copy()

    session = Session(spec, callbacks=[_FreezeLadder()], device=device)
    outcome = session.run()

    burn = outcome.phases["burn"]
    betas_frozen = frozen["betas"]
    temps = 1.0 / betas_frozen.astype(np.float64)

    series = ["energy"] + sorted(entry.observable_names)
    bm = {k: [] for k in series}  # per-window (C, R) means
    pv = {k: [] for k in series}  # per-window (C, R) variances
    for phase in spec.schedule.phases[1:]:
        res = outcome.phases[phase.name]
        for k in series:
            bm[k].append(np.atleast_2d(res.summary[f"mean_{k}"]))
            pv[k].append(np.atleast_2d(res.summary[f"var_{k}"]))
    if not np.array_equal(outcome.state.betas.cpu().numpy(), betas_frozen):
        raise RuntimeError(
            f"{entry.name}: ladder retuned during measurement; increase "
            "burn_sweeps so all adapt_rounds fire before the batches start"
        )

    exact = {k: np.asarray(v, np.float64)
             for k, v in exact_fn(session.system, temps).items()}
    means, mcse, z, ess, geweke = {}, {}, {}, {}, {}
    half = entry.n_batches // 2
    for k in series:
        cells = np.concatenate(bm[k], axis=0)  # (B*C, R)
        grand, se, _ = batch_mean_stats(cells)
        means[k], mcse[k] = grand, se
        z[k] = (grand - exact[k]) / np.maximum(se, 1e-300)
        ess[k] = effective_sample_size(np.concatenate(pv[k], axis=0).mean(axis=0), se)
        geweke[k] = geweke_z(np.concatenate(bm[k][:half], axis=0),
                             np.concatenate(bm[k][half:], axis=0))
    return ConformanceReport(
        name=entry.name,
        temps=temps,
        n_retunes=len(burn.ladder_history) - 1,
        means=means,
        mcse=mcse,
        exact=exact,
        z=z,
        ess=ess,
        geweke=geweke,
        n_batches=entry.n_batches * entry.n_chains,
    )


def assert_conforms(
    report: ConformanceReport,
    z_max: float = 4.0,
    geweke_max: float = 4.0,
    atol: float = 2e-3,
) -> None:
    """Raise AssertionError unless every series conforms at every rung.

    ``|mean - exact| <= z_max * MCSE + atol * (1 + |exact|)``: the absolute
    floor covers saturated observables (|m| -> 1 at the cold end) whose batch
    means collapse and make raw z unstable.  The Geweke score guards the
    stationarity of the measurement window itself.
    """
    for k in report.means:
        err = np.abs(report.means[k] - report.exact[k])
        tol = z_max * report.mcse[k] + atol * (1.0 + np.abs(report.exact[k]))
        assert np.all(err <= tol), (
            f"{report.name}/{k}: engine mean disagrees with exact reference\n"
            f"  temps={report.temps.round(4)}\n  mean ={report.means[k]}\n"
            f"  exact={report.exact[k]}\n  mcse ={report.mcse[k]}\n"
            f"  |z|  ={np.abs(report.z[k]).round(2)} (max {z_max})"
        )
        g = np.abs(report.geweke[k])
        assert np.all(g <= geweke_max), (
            f"{report.name}/{k}: Geweke drift |z|={g.round(2)} exceeds "
            f"{geweke_max}; measurement window not stationary"
        )
