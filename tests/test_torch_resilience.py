"""The port's fault injection, supervision and degradation
(`repro_torch.resilience`) against the JAX package's.

* `SITES` and `RECOVERABLE_SITES` are JAX's; `FaultPlan.from_seed` draws
  JAX's schedule from the same seed; `RetryPolicy.delay` gives JAX's
  backoff; plan and supervisor semantics match;
* with ``faults=None`` the plan is never consulted; the kernel launches and
  the results are the same with a plan armed that never fires;
* degradation: an injected ``engine.compile`` fault, or a refused launch,
  on a fused or round path degrades the engine to the per-sweep path on
  its own device, bit-equal to a never-fused run (warning, counter,
  ``on_degrade``); ``strict_kernels`` makes it fatal; a system with no
  kernel flag propagates the error;
* the checkpoint manager's write seams tear, corrupt or crash as JAX's do,
  and restore falls back past the damaged generation;
* served buckets: transient faults recover bit-equal, a quarantine fails
  its jobs typed and writes its manifest, a non-finite lane fails only its
  tenant, and a seeded chaos run leaves every job bit-equal to its
  fault-free run or failed with a typed error.
"""
import json
import os
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.resilience import RECOVERABLE_SITES as JRECOVERABLE  # noqa: E402
from repro.resilience import SITES as JSITES  # noqa: E402
from repro.resilience import FaultPlan as JFaultPlan  # noqa: E402
from repro.resilience import RetryPolicy as JRetryPolicy  # noqa: E402
from repro_torch.api import EngineSpec, LadderSpec, PhaseSpec, RunSpec  # noqa: E402
from repro_torch.api import ScheduleSpec, SystemSpec  # noqa: E402
from repro_torch.checkpoint import CheckpointCorrupt, CheckpointManager  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core.ising import IsingSystem  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    RECOVERABLE_SITES,
    SITES,
    BucketQuarantined,
    Fault,
    FaultPlan,
    InjectedCrash,
    InjectedFault,
    RetryPolicy,
    Supervisor,
    WatchdogTimeout,
)
from repro_torch.resilience import faults as faults_mod  # noqa: E402
from repro_torch.resilience.supervisor import QUARANTINE_NAME  # noqa: E402
from repro_torch.serve import JobFailedError, JobState, Scheduler  # noqa: E402

TEMPS = np.geomspace(1.5, 3.5, 4)


def test_sites_are_jaxs():
    assert SITES == JSITES and RECOVERABLE_SITES == JRECOVERABLE


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_faults", [3, 5])
def test_from_seed_draws_jaxs_schedule(seed, n_faults):
    got = FaultPlan.from_seed(seed, n_faults=n_faults)
    want = JFaultPlan.from_seed(seed, n_faults=n_faults)
    as_tuples = lambda p: [(f.site, f.at, f.duration, f.chain) for f in p.faults]  # noqa: E731
    assert as_tuples(got) == as_tuples(want)
    sites = sorted(SITES)[:3]
    assert as_tuples(FaultPlan.from_seed(seed, sites=sites, max_occurrence=2)) == \
        as_tuples(JFaultPlan.from_seed(seed, sites=sites, max_occurrence=2))


@pytest.mark.parametrize("policy", [dict(), dict(base_delay_s=0.5, jitter=0.1),
                                    dict(max_delay_s=0.3, base_delay_s=0.2)])
def test_backoff_delays_are_jaxs(policy):
    got, want = RetryPolicy(**policy), JRetryPolicy(**policy)
    for key in ("bucket-0001", "abc123-0000", ""):
        for attempt in range(1, 8):
            assert got.delay(key, attempt) == want.delay(key, attempt)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


def test_plan_semantics():
    fired = []
    plan = FaultPlan([Fault("engine.chunk.launch", at=(1, 3)),
                      {"site": "serve.callback"}], on_fire=fired.append)
    assert [plan.check("engine.chunk.launch") is not None for _ in range(5)] == \
        [False, True, False, True, False]
    with pytest.raises(InjectedFault, match="serve.callback"):
        plan.fire("serve.callback")
    plan.fire("serve.callback")  # occurrence 1: not armed
    assert plan.fired() == 3 and plan.fired("serve.callback") == 1
    assert [f.site for f in fired] == ["engine.chunk.launch"] * 2 + ["serve.callback"]
    with pytest.raises(ValueError, match="unknown fault site"):
        Fault("nowhere")


# -- the supervisor on a host-only bucket -------------------------------------------


class _Job:
    def __init__(self, jid):
        self.id, self.state, self.error = jid, JobState.RUNNING, None

    def _fail(self, err):
        self.error, self.state = err, JobState.FAILED


class _Bucket:
    def __init__(self, failures, error=None, generation=0, jobs=None):
        self.digest, self.name, self.manager, self.faults = "fake", "fake-0000", None, None
        self.finished, self.sweeps_done, self.restore_fallback_depth = False, 0, 0
        self._failures, self._error = failures, error or InjectedFault("boom")
        self._failed = set()
        self.jobs = jobs or [_Job("a"), _Job("b")]
        self.generation = generation

    def live_jobs(self):
        return [j for j in self.jobs if j.id not in self._failed]

    def run_quantum(self, chunks):
        if self._failures > 0:
            self._failures -= 1
            raise self._error
        self.finished = True
        return True

    def recover(self):
        return _Bucket(self._failures, self._error, self.generation + 1, self.jobs)

    def abandon(self):
        pass


@pytest.mark.parametrize("failures, max_attempts, quarantined", [(2, 3, False), (9, 2, True)])
def test_supervisor_retries_or_quarantines(failures, max_attempts, quarantined):
    slept = []
    sup = Supervisor(policy=RetryPolicy(max_attempts=max_attempts, base_delay_s=0.25),
                     sleep=slept.append)
    out = sup.run(_Bucket(failures), 1)
    assert out.finished and out.quarantined is quarantined
    assert len(slept) == min(failures, max_attempts - 1)
    assert slept == [RetryPolicy(base_delay_s=0.25).delay("fake-0000", a + 1)
                     for a in range(len(slept))]
    if quarantined:
        assert all(isinstance(j.error, BucketQuarantined) for j in out.bucket.jobs)
        assert sup.totals["quarantined_jobs"] == 2
    else:
        assert out.retries == 2 and out.bucket.generation == 2


def test_supervisor_wedged_watchdog_quarantines_at_once():
    sup = Supervisor(policy=RetryPolicy(max_attempts=5), sleep=lambda s: None)
    out = sup.run(_Bucket(9, WatchdogTimeout("stuck", wedged=True)), 1)
    assert out.quarantined and out.retries == 0


# -- the engine: zero-cost off and degradation ----------------------------------------


def _cfg(**kw):
    return EngineConfig(**dict(dict(n_replicas=4, swap_interval=2, chunk_intervals=2), **kw))


def test_faults_off_never_consults_the_plan(monkeypatch):
    def bomb(*a, **k):
        raise AssertionError("fault plan consulted with faults=None")

    for meth in ("check", "fire"):
        monkeypatch.setattr(faults_mod.FaultPlan, meth, bomb)
    eng = Engine(IsingSystem(length=4, use_fused=True, use_fused_round=True), _cfg(),
                 device="cpu")
    _, res = eng.run(eng.init(keys.key(0), TEMPS), 8)
    assert res.n_sweeps == 8


@pytest.mark.parametrize("flags", [dict(use_fused=True),
                                   dict(use_fused=True, use_fused_round=True, pack_bits=True)])
def test_armed_plan_that_never_fires_changes_nothing(flags):
    runs = []
    for faults in (None, FaultPlan([Fault("engine.chunk.launch", at=(99,))])):
        eng = Engine(IsingSystem(length=4, **flags), _cfg(n_chains=2), device="cpu",
                     faults=faults)
        build.reset_launches()
        st, res = eng.run(eng.init(keys.key(3), TEMPS), 8)
        runs.append((st.pt.states, st.pt.energy, st.pt.rung, dict(build.launches)))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][:3], runs[1][:3]))
    assert runs[0][3] == runs[1][3]


@pytest.mark.parametrize("how", ["compile fault", "refused launch"])
@pytest.mark.parametrize("flags", [dict(use_fused=True),
                                   dict(use_fused=True, use_fused_round=True),
                                   dict(use_fused=True, use_fused_round=True, pack_bits=True)])
def test_degradation_is_the_never_fused_run(how, flags, monkeypatch):
    obs, calls = Observability.create(timeline=False), []
    faults = FaultPlan([Fault("engine.compile")]) if how == "compile fault" else None
    eng = Engine(IsingSystem(length=4, **flags), _cfg(n_chains=2), device="cpu", obs=obs,
                 faults=faults, on_degrade=lambda: calls.append(1))
    if how == "refused launch":
        from repro_torch.engine import driver

        real = driver.Engine._issue

        def refuse_fused(self, state, n):
            if getattr(self.system, "use_fused", False):
                raise build.KernelError("ising_fused launch failed with cudaError 1")
            return real(self, state, n)

        monkeypatch.setattr(driver.Engine, "_issue", refuse_fused)
    with pytest.warns(RuntimeWarning, match="degrading to the per-sweep path on cpu"):
        st, res = eng.run(eng.init(keys.key(0), TEMPS), 8)
    assert not any(getattr(eng.system, f) for f in flags)
    assert calls == [1]
    assert obs.metrics.snapshot()["pt_degraded_kernel"]["samples"][0]["value"] == 1
    ref = Engine(IsingSystem(length=4), _cfg(n_chains=2), device="cpu")
    st2, res2 = ref.run(ref.init(keys.key(0), TEMPS), 8)
    for a, b in zip((st.pt.states, st.pt.energy, st.pt.rung), (st2.pt.states, st2.pt.energy,
                                                              st2.pt.rung)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    assert all(np.array_equal(res.summary[k], res2.summary[k]) for k in res.summary)


def test_strict_kernels_and_plain_systems_raise():
    for system, strict in ((IsingSystem(length=4, use_fused=True), True),
                           (IsingSystem(length=4), False)):
        eng = Engine(system, _cfg(), device="cpu", strict_kernels=strict,
                     faults=FaultPlan([Fault("engine.compile")]))
        with pytest.raises(InjectedFault):
            eng.run(eng.init(keys.key(0), TEMPS), 8)


# -- checkpoint write seams ---------------------------------------------------------


@pytest.mark.parametrize("site", ["checkpoint.write.torn", "checkpoint.write.corrupt",
                                  "checkpoint.write.crash_before_rename",
                                  "checkpoint.write.crash_after_rename"])
def test_checkpoint_write_seams(tmp_path, site):
    eng = Engine(IsingSystem(length=4), _cfg(), device="cpu")
    st = eng.init(keys.key(1), TEMPS)
    plan = FaultPlan([Fault(site, at=(1,))])
    mgr = CheckpointManager(str(tmp_path), faults=plan).child("bucket")
    mgr.save(2, st)
    st2, _ = eng.run(st, 4)
    if "crash" in site:
        with pytest.raises(InjectedCrash):
            mgr.save(6, st2)
    else:
        mgr.save(6, st2)
    assert plan.fired(site) == 1
    state, meta = mgr.restore_latest(st)
    if site == "checkpoint.write.corrupt":
        with pytest.raises(CheckpointCorrupt):
            mgr._verify(6)
        assert meta["step"] == 2 and mgr.last_restore_fallback == 1
        assert torch.equal(state.pt.states, st.pt.states)
    elif site == "checkpoint.write.torn":
        # a torn step has the wrong size: retention drops it as unreadable
        assert mgr.steps() == [2] and meta["step"] == 2
        assert torch.equal(state.pt.states, st.pt.states)
    elif site.endswith("before_rename"):
        assert mgr.steps() == [2] and meta["step"] == 2
    else:
        assert meta["step"] == 6 and torch.equal(state.pt.states, st2.pt.states)


# -- served buckets ---------------------------------------------------------------


def _spec(seed):
    return RunSpec(
        system=SystemSpec("ising", {"length": 4, "use_fused": True, "use_fused_round": True}),
        ladder=LadderSpec(kind="geometric", n_replicas=4, t_min=1.5, t_max=3.5),
        engine=EngineSpec(swap_interval=2, chunk_intervals=2),
        schedule=ScheduleSpec(phases=(PhaseSpec("burn", 8),
                                      PhaseSpec("measure", 8, reset_stats=True))),
        observables=("mag",), seed=seed)


def _serve(faults=None, ckdir=None, **kw):
    kw.setdefault("retry_backoff_s", 0.001)
    sched = Scheduler(device="cpu", checkpoint_dir=ckdir, checkpoint_every_quanta=1,
                      faults=faults, strict_kernels=True, **kw)
    jobs = [sched.submit(_spec(s), job_id=f"j{s}") for s in range(3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sched.run_until_idle()
    return sched, jobs


@pytest.fixture(scope="module")
def baseline():
    _, jobs = _serve()
    return {j.id: j.result(timeout=0) for j in jobs}


def _assert_bit_equal(got, want):
    assert np.array_equal(got.final_energy, want.final_energy)
    assert set(got.phases) == set(want.phases)
    for name, summary in want.phases.items():
        for k, v in summary.items():
            assert np.array_equal(np.asarray(got.phases[name][k]), np.asarray(v)), (name, k)


def test_transient_faults_recover_bit_equal(tmp_path, baseline):
    plan = FaultPlan([Fault("engine.chunk.launch", at=(1, 5)),
                      Fault("checkpoint.write.torn", at=(0,)),
                      Fault("engine.compile", at=(0,))])
    sched, jobs = _serve(faults=plan, ckdir=str(tmp_path))
    assert plan.fired() == 4 and sched._supervisor.totals["retries"] >= 3
    for j in jobs:
        _assert_bit_equal(j.result(timeout=0), baseline[j.id])
    fired = {tuple(s["labels"].values()): s["value"]
             for s in sched.metrics()["pt_fault_injected"]["samples"]}
    assert fired[("engine.chunk.launch",)] == 2


def test_quarantine_fails_jobs_typed_and_writes_its_manifest(tmp_path):
    plan = FaultPlan([Fault("engine.chunk.launch", at=tuple(range(64)))])
    sched, jobs = _serve(faults=plan, ckdir=str(tmp_path), max_attempts=2)
    for j in jobs:
        with pytest.raises(JobFailedError) as err:
            j.result(timeout=0)
        assert isinstance(err.value.__cause__, BucketQuarantined)
    (path,) = [os.path.join(tmp_path, n, QUARANTINE_NAME) for n in os.listdir(tmp_path)
               if os.path.isfile(os.path.join(tmp_path, n, QUARANTINE_NAME))]
    man = json.load(open(path))
    assert man["attempts"] == 2 and sorted(man["jobs"]) == ["j0", "j1", "j2"]
    assert man["fired_faults"] and sched.stats()["resilience"]["quarantined_jobs"] == 3


@pytest.mark.parametrize("site, chain", [("engine.energy.nonfinite", 1), ("serve.callback", 0)])
def test_a_faulty_lane_or_callback_fails_one_tenant(site, chain, baseline):
    plan = FaultPlan([Fault(site, at=(1,), chain=chain)])
    _, jobs = _serve(faults=plan)
    failed = [j for j in jobs if j.state is JobState.FAILED]
    assert len(failed) == 1
    assert isinstance(failed[0].error,
                      FloatingPointError if "nonfinite" in site else InjectedFault)
    for j in jobs:
        if j.state is JobState.DONE:
            _assert_bit_equal(j.result(timeout=0), baseline[j.id])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_invariant(seed, tmp_path, baseline):
    plan = FaultPlan.from_seed(seed, n_faults=4)
    _, jobs = _serve(faults=plan, ckdir=str(tmp_path), max_attempts=3)
    for j in jobs:
        if j.state is JobState.DONE:
            _assert_bit_equal(j.result(timeout=0), baseline[j.id])
        else:
            assert isinstance(j.error, (InjectedFault, InjectedCrash, BucketQuarantined,
                                        FloatingPointError, WatchdogTimeout)), repr(j.error)
    for name in os.listdir(tmp_path):
        m = CheckpointManager(os.path.join(tmp_path, name))
        for step in m.steps():
            try:
                m._verify(step)
            except CheckpointCorrupt:
                pass  # an injected torn or flipped write, caught typed
