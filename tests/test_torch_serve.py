"""The port's serve layer (`repro_torch.serve`) against the JAX package's.

* `shape_signature` gives JAX's digest for the same spec; `check_servable`
  refuses what JAX's refuses;
* a burst of 4 tenants of ``examples/specs/ising_serve.json`` on the
  per-sweep path and on the whole-round path (``use_fused_round``: one
  kernel call a round for the whole bucket) equals JAX's `Scheduler`
  results (counters and final energies exact, Welford means within 1e-6
  relative, variances within 1e-5: ROADMAP queue 3's ulp rules) and the
  port's solo `Session` runs bit for bit, with one preparation for the
  bucket;
* `Engine.init_ensemble` equals JAX's, chain by chain;
* the chain-axis ops on the CPU (their plain versions chain by chain) equal
  per-chain calls, for kernels A, #2p and #5, sweeps and rounds;
* checkpointed preemption: a bucket stopped mid-schedule resumes through
  `Scheduler.from_checkpoint` bit-equal, in the port, and across packages
  in both directions (the bucket directories are in JAX's formats);
* round-robin fairness, failure isolation, the job lifecycle, the bounded
  queue and the service thread;
* ``python -m repro_torch serve ... --device cpu`` writes its manifest.

JAX runs on the CPU (``JAX_PLATFORMS=cpu``); inputs come from seeds.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.api import RunSpec as JSpec  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import check_servable as jcheck_servable  # noqa: E402
from repro.serve import shape_signature as jshape_signature  # noqa: E402
from repro_torch.api import RunSpec, Session  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    JobFailedError,
    JobQueue,
    JobState,
    QueueFull,
    Scheduler,
    SchedulerStopped,
    check_servable,
    shape_signature,
)

ROOT = Path(__file__).resolve().parents[1]
SERVE_SPEC = ROOT / "examples" / "specs" / "ising_serve.json"
EXACT = ("n_records", "swap_attempts", "swap_acceptance", "round_trips", "flow_up")


def _spec_dict(path="sweep", **params):
    d = json.loads(SERVE_SPEC.read_text())
    if path == "round":
        d["system"]["params"].update(use_fused=True, use_fused_round=True)
    elif path == "fused":
        d["system"]["params"].update(use_fused=True)
    d["system"]["params"].update(params)
    return d


def _tenants(d, n=4):
    return [RunSpec.from_dict({**d, "seed": s}) for s in range(n)]


def _serve(specs, **kw):
    sched = Scheduler(device="cpu", **kw)
    jobs = [sched.submit(s, job_id=f"j{i}") for i, s in enumerate(specs)]
    sched.run_until_idle()
    return sched, jobs


def _assert_equal_solo(result, spec):
    ref = Session(spec, device="cpu").run()
    assert np.array_equal(result.final_energy, ref.final_energies())
    assert set(result.phases) == set(ref.phases)
    for name, res in ref.phases.items():
        for k, v in res.summary.items():
            assert np.array_equal(np.asarray(result.phases[name][k]), np.asarray(v)), (name, k)


def _assert_equal_jax(got: dict, want: dict):
    """Manifests of one job from the two packages: counters and final
    energies exact, means within 1e-6 relative, variances within 1e-5."""
    assert got["n_sweeps"] == want["n_sweeps"]
    assert np.array_equal(got["final_energy"], want["final_energy"])
    assert set(got["phases"]) == set(want["phases"])
    for name, summary in want["phases"].items():
        for k, v in summary.items():
            a, b = np.asarray(got["phases"][name][k]), np.asarray(v)
            if k in EXACT:
                assert np.array_equal(a, b), (name, k)
            else:
                rtol = 1e-6 if k.startswith("mean_") else 1e-5
                np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=f"{name}.{k}")


@pytest.fixture(scope="module")
def jax_results():
    """JAX's Scheduler over 4 tenants of each path (module-cached)."""
    out = {}
    for path in ("sweep", "round"):
        sched = JScheduler()
        d = _spec_dict(path)
        jobs = [sched.submit(JSpec.from_dict({**d, "seed": s}), job_id=f"j{s}")
                for s in range(4)]
        sched.run_until_idle()
        out[path] = {j.id: j.result(timeout=0).manifest() for j in jobs}
    return out


# -- signature / servability ------------------------------------------------------


@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
@pytest.mark.parametrize("seed", [0, 7])
def test_shape_signature_is_jaxs(path, seed):
    d = {**_spec_dict(path), "seed": seed}
    got = shape_signature(RunSpec.from_dict(d))
    want = jshape_signature(JSpec.from_dict(d))
    assert got[0] == want[0] and got[1] == want[1]
    other = shape_signature(RunSpec.from_dict({**d, "seed": seed + 1}))[0]
    assert other == got[0]  # only the seed is left out
    assert shape_signature(RunSpec.from_dict(_spec_dict(path, length=6)))[0] != got[0]


@pytest.mark.parametrize("edit", ["adapt", "mesh"])
def test_check_servable_refuses_what_jax_refuses(edit):
    d = _spec_dict()
    if edit == "adapt":
        d["schedule"]["phases"][0]["adapt"] = True
        d["adapt"] = {"target": 0.3}
    else:
        d["engine"]["mesh"] = {"ensemble": 1, "replica": 1}
    with pytest.raises(ValueError) as jerr:
        jcheck_servable(JSpec.from_dict(d))
    # the same JSON in both packages: the port parses engine.mesh into its
    # MeshSpec since the multi-device slice
    with pytest.raises(ValueError) as terr:
        check_servable(RunSpec.from_dict(d))
    assert str(terr.value) == str(jerr.value)


# -- packed tenants -----------------------------------------------------------------


@pytest.mark.parametrize("path", ["sweep", "round"])
def test_burst_equals_jax_scheduler_and_solo_sessions(path, jax_results):
    specs = _tenants(_spec_dict(path))
    sched, jobs = _serve(specs)
    stats = sched.stats()
    assert stats["n_compiles"] == 1 and stats["n_engines"] == 1
    assert stats["states"]["done"] == 4
    for job, spec in zip(jobs, specs):
        res = job.result(timeout=0)
        _assert_equal_jax(json.loads(json.dumps(res.manifest())), jax_results[path][job.id])
        _assert_equal_solo(res, spec)


def test_streamed_energies_equal_solo_chunks():
    specs = _tenants(_spec_dict("round"), 3)
    seen = {}
    sched = Scheduler(device="cpu")
    for s in specs:
        sched.submit(s, on_update=lambda job, u: seen.setdefault(job.id, []).append(u),
                     job_id=f"j{s.seed}")
    sched.run_until_idle()
    for s in specs:
        chunks = []

        class Grab:
            consumes_trace = False

            def on_phase_start(self, *a): pass
            def on_adapt(self, *a): pass
            def on_phase_end(self, *a): pass
            def on_checkpoint(self, *a): pass

            def on_chunk(self, session, info):
                e, r = info.state.pt.energy.numpy(), info.state.pt.rung.numpy()
                chunks.append(e[np.argsort(r)])

        Session(s, callbacks=[Grab()], device="cpu").run()
        got = seen[f"j{s.seed}"]
        assert len(got) == len(chunks)
        assert all(np.array_equal(u.energy, e) for u, e in zip(got, chunks))
        assert [u.sweeps_done for u in got] == [40, 80, 120, 160]


@pytest.mark.parametrize("path", ["sweep", "round"])
def test_ensemble_tenants_and_traces_pack_bit_equal(path):
    d = _spec_dict(path)
    d["engine"].update(n_chains=2, record_trace=True)
    specs = [RunSpec.from_dict({**d, "seed": s}) for s in (3, 4)]
    traces = {}
    sched = Scheduler(device="cpu")
    jobs = [sched.submit(s, on_update=lambda job, u: traces.setdefault(job.id, []).append(
        u.trace)) for s in specs]
    sched.run_until_idle()
    for job, spec in zip(jobs, specs):
        _assert_equal_solo(job.result(timeout=0), spec)
        assert traces[job.id][0]["energy"].shape == (2, 4, 8)


def test_init_ensemble_equals_jax():
    seeds = (5, 9, 11)
    cfg = dict(n_replicas=4, swap_interval=2, chunk_intervals=2, n_chains=len(seeds))
    params = {"length": 6, "use_fused": True, "use_fused_round": True}
    temps = np.geomspace(1.0, 3.0, 4)
    jeng = JEngine(jsystems.make_system("ising", params), JEngineConfig(**cfg))
    teng = Engine(tsystems.make_system("ising", params), EngineConfig(**cfg), device="cpu")
    jst = jeng.init_ensemble([jax.random.key(s) for s in seeds], temps)
    tst = teng.init_ensemble([keys.key(s) for s in seeds], temps)
    assert np.array_equal(tst.pt.states.numpy(), np.asarray(jst.pt.states))
    assert np.array_equal(tst.pt.energy.numpy(), np.asarray(jst.pt.energy))
    assert np.array_equal(tst.pt.rung.numpy(), np.asarray(jst.pt.rung))
    assert np.array_equal(tst.pt.key.numpy().astype(np.uint32),
                          np.asarray(jax.random.key_data(jst.pt.key)))
    for c, s in enumerate(seeds):  # chain c is the solo init from keys[c]
        solo = Engine(tsystems.make_system("ising", params),
                      EngineConfig(**{**cfg, "n_chains": 1}), device="cpu").init(
            keys.key(s), temps)
        assert torch.equal(tst.pt.states[c], solo.pt.states)
    with pytest.raises(ValueError, match="keys"):
        teng.init_ensemble([keys.key(0)], temps)


# -- the chain-axis ops (plain versions, chain by chain) ------------------------------


def _chain_args(kernel, c, r, length, seed):
    rng = np.random.default_rng(seed)
    if kernel == "potts":
        st = rng.integers(0, 3, (c, r, length, length)).astype(np.int8)
    else:
        st = rng.choice(np.array([-1, 1], np.int8), size=(c, r, length, length))
    rung = np.stack([rng.permutation(r) for _ in range(c)]).astype(np.int32)
    energy = -rng.integers(0, 50, (c, r)).astype(np.float32)
    betas = (1.0 / np.geomspace(1.0, 4.0, r)).astype(np.float32)
    key = torch.stack([keys.key(seed + i) for i in range(c)])
    t = torch.from_numpy(rng.integers(0, 99, c))
    ph = torch.from_numpy(rng.integers(0, 99, c))
    return (torch.from_numpy(st), key, t, ph, torch.from_numpy(rung),
            torch.from_numpy(energy), torch.from_numpy(betas))


@pytest.mark.parametrize("kernel", ["A", "2p", "potts"])
@pytest.mark.parametrize("c", [1, 3])
def test_chain_axis_ops_equal_per_chain_calls(kernel, c):
    st, key, t, ph, rung, energy, betas = _chain_args(kernel, c, 5, 4, 17 + c)
    kw = dict(n_sweeps=2, rule="glauber")
    if kernel == "potts":
        fused = lambda *a, **k: ops.potts_sweep_fused(*a, q=3, **k)  # noqa: E731
        rnd = lambda *a, **k: ops.potts_round_fused(*a, q=3, **k)  # noqa: E731
    else:
        fused = lambda *a, **k: ops.ising_sweep_fused(*a, pack_bits=kernel == "2p", **k)  # noqa: E731
        rnd = lambda *a, **k: ops.ising_round_fused(*a, pack_bits=kernel == "2p", **k)  # noqa: E731
    slot_betas = betas[rung.long()]
    got_f = fused(st, key, t, slot_betas, **kw)
    got_r = rnd(st, key, t, ph, rung, energy, betas, n_rounds=2, pairing="seo", **kw)
    for i in range(c):
        want_f = fused(st[i], key[i], t[i], slot_betas[i], **kw)
        want_r = rnd(st[i], key[i], t[i], ph[i], rung[i], energy[i], betas, n_rounds=2,
                     pairing="seo", **kw)
        assert all(torch.equal(x[i], y) for x, y in zip(got_f, want_f))
        for n, (x, y) in enumerate(zip(got_r, want_r)):
            assert torch.equal(x[:, i] if n >= 4 else x[i], y)


def test_chain_axis_ops_refuse_mismatched_keys():
    st, key, t, _, _, _, betas = _chain_args("A", 3, 5, 4, 1)
    with pytest.raises(ValueError, match="keys of shape"):
        ops.ising_sweep_fused(st, key[:2], t, betas.expand(3, 5), n_sweeps=1)


# -- preemption and restart -----------------------------------------------------------


def _small(path="round"):
    d = _spec_dict(path)
    d["schedule"]["phases"] = [{"name": "burn", "n_sweeps": 40},
                               {"name": "measure", "n_sweeps": 40, "reset_stats": True}]
    d["engine"]["chunk_intervals"] = 2
    return d


@pytest.mark.parametrize("quantum_chunks", [1, 3])
def test_preemption_slicing_is_invisible(quantum_chunks):
    d = _small()
    _, ref = _serve(_tenants(d, 2))
    # a second shape in the round-robin forces preemption between quanta
    sched, jobs = _serve(_tenants(d, 2) + _tenants(_small("sweep"), 1),
                         quantum_chunks=quantum_chunks)
    assert len(set(sched.quantum_log)) == 2
    for a, b in zip(jobs[:2], ref):
        ra, rb = a.result(timeout=0), b.result(timeout=0)
        assert np.array_equal(ra.final_energy, rb.final_energy)


def _stop_after(sched_cls, d, ckdir, quanta, **kw):
    sched = sched_cls(checkpoint_dir=str(ckdir), checkpoint_every_quanta=1, **kw)
    spec_cls = RunSpec if sched_cls is Scheduler else JSpec
    for s in range(2):
        sched.submit(spec_cls.from_dict({**d, "seed": s}), job_id=f"j{s}")
    sched.run_until_idle(max_quanta=quanta)
    return sched


@pytest.mark.parametrize("direction", ["port", "jax_to_port", "port_to_jax"])
def test_checkpointed_restart_resumes_bit_equal(tmp_path, direction):
    d = _small()
    _, ref = _serve(_tenants(d, 2))
    ref = {j.id: j.result(timeout=0) for j in ref}
    first = JScheduler if direction == "jax_to_port" else Scheduler
    kw = {} if first is JScheduler else {"device": "cpu"}
    stopped = _stop_after(first, d, tmp_path, 2, **kw)
    assert not all(j.done() for j in stopped.jobs.values())
    if direction == "port_to_jax":
        resumed = JScheduler.from_checkpoint(str(tmp_path))
    else:
        resumed = Scheduler.from_checkpoint(str(tmp_path), device="cpu")
    resumed.run_until_idle()
    for jid, want in ref.items():
        got = resumed.jobs[jid].result(timeout=0)
        if direction == "port_to_jax":
            np.testing.assert_array_equal(np.asarray(got.final_energy), want.final_energy)
        else:
            assert np.array_equal(got.final_energy, want.final_energy)
        # the phase that ended after the restore point is carried in full
        for k, v in want.phases["measure"].items():
            a = np.asarray(got.phases["measure"][k])
            if direction == "port" or k in EXACT:
                assert np.array_equal(a, np.asarray(v)), k
            else:
                np.testing.assert_allclose(a, np.asarray(v), rtol=1e-5, atol=1e-6)


def test_restart_of_finished_bucket_delivers_immediately(tmp_path):
    d = _small()
    sched = Scheduler(checkpoint_dir=str(tmp_path), device="cpu")
    jobs = [sched.submit(RunSpec.from_dict({**d, "seed": 1}), job_id="j1")]
    sched.run_until_idle()
    again = Scheduler.from_checkpoint(str(tmp_path), device="cpu")
    assert again.idle()
    assert np.array_equal(again.jobs["j1"].result(timeout=0).final_energy,
                          jobs[0].result(timeout=0).final_energy)


# -- fairness, isolation, lifecycle -----------------------------------------------------


def test_round_robin_never_starves_a_bucket():
    sched = Scheduler(device="cpu")
    for path in ("sweep", "round", "fused"):
        sched.submit(RunSpec.from_dict(_small(path)))
    sched.run_until_idle()
    log = sched.quantum_log
    # three buckets of 4 chunks each: strict rotation while all three live
    assert log[:3] == log[3:6] and len(set(log[:3])) == 3
    assert sched.stats()["n_engines"] == 3


def test_failing_tenant_does_not_take_down_its_bucket():
    specs = _tenants(_small(), 3)
    sched = Scheduler(device="cpu")

    def boom(job, update):
        raise RuntimeError("tenant callback")

    jobs = [sched.submit(s, on_update=boom if s.seed == 1 else None) for s in specs]
    sched.run_until_idle()
    assert jobs[1].state is JobState.FAILED
    with pytest.raises(JobFailedError):
        jobs[1].result(timeout=0)
    for j, s in ((jobs[0], specs[0]), (jobs[2], specs[2])):
        _assert_equal_solo(j.result(timeout=0), s)


def test_service_thread_lifecycle_and_bounded_queue():
    q = JobQueue(maxsize=1)
    q.put("x")
    with pytest.raises(QueueFull):
        q.put("y", block=True, timeout=0.01)
    assert q.drain() == ["x"] and len(q) == 0
    sched = Scheduler(device="cpu", queue_depth=1)
    a = sched.submit(RunSpec.from_dict(_small()))
    with pytest.raises(QueueFull):
        sched.submit(RunSpec.from_dict({**_small(), "seed": 1}))
    assert a.state is JobState.PENDING and len(sched.jobs) == 1
    sched.start()
    assert a.result(timeout=60).n_sweeps == 80
    b = sched.submit(RunSpec.from_dict({**_small(), "seed": 2}), block=True, timeout=60)
    sched.shutdown(wait=True)
    assert b.state is JobState.DONE
    late = Scheduler(device="cpu")
    c = late.submit(RunSpec.from_dict(_small()))
    late.shutdown()
    assert isinstance(c.error, SchedulerStopped)
    json.dumps(a.result(timeout=0).manifest())


def test_cli_serve_writes_its_manifest(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "serve", str(SERVE_SPEC), "--jobs", "2",
         "--device", "cpu", "--out", str(tmp_path), "--timeline",
         str(tmp_path / "serve.trace.json"), "--quiet"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    data = json.loads((tmp_path / "serve_results.json").read_text())
    assert sorted(data["results"]) == ["ising_serve-seed0", "ising_serve-seed1"]
    assert data["failed"] == {} and data["scheduler"]["n_compiles"] == 1
    assert (tmp_path / "metrics.prom").read_text().count("serve_quanta_total") >= 1
    from repro_torch.obs.check_trace import validate_trace

    validate_trace(json.loads((tmp_path / "serve.trace.json").read_text()),
                   require_spans=["quantum", "chunk"])
