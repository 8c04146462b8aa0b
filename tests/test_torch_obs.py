"""The port's telemetry layer (`repro_torch.obs`) against the JAX package's.

* the same sequence of registry operations gives JAX's snapshot, and
  `to_prometheus`, `to_json` and `snapshot_digest` give JAX's bytes;
* the port's timelines pass both packages' `check_trace`, and the port's
  validator rejects what JAX's rejects, with JAX's messages;
* the engine's metric families are JAX's (names, kinds, help strings);
  with obs off no obs object is built or touched; obs on or off leaves the
  results (and, where the plain path counts them, the launches) unchanged;
  the spans JAX's engine records appear;
* `ObsCallback`, ``run --timeline --metrics-out --torch-profile`` and the
  one-chunk `torch.profiler` window write their files; a profiler that
  cannot start is an instant on the timeline, never a failed run;
* `_modeled_hbm_bytes` models the port's kernels (no uniform planes on the
  fused paths);
* the scheduler's metrics and timeline lanes.

JAX runs on the CPU (``JAX_PLATFORMS=cpu``); inputs come from numpy seeds.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import Observability as JObservability  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs.check_trace import TraceError as JTraceError  # noqa: E402
from repro.obs.check_trace import validate_trace as jvalidate  # noqa: E402
from repro_torch.api import ObsCallback, RunSpec, Session  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.engine import driver as tdriver  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL,
    MetricsRegistry,
    Observability,
    Timeline,
    export,
    snapshot_digest,
    to_json,
    to_prometheus,
)
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import timeline as ttimeline  # noqa: E402
from repro_torch.obs.check_trace import TraceError, validate_trace  # noqa: E402
from repro_torch.serve import Scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "examples" / "specs"
R = 4
TEMPS = np.geomspace(1.5, 3.5, R)


def _ops(seed: int, n: int = 60):
    """A seeded sequence of registry operations: (family kind, name, labels,
    label values, method, value)."""
    rng = np.random.default_rng(seed)
    fams = [("counter", "req_total", ()), ("counter", "bytes_total", ("kind",)),
            ("gauge", "queue_depth", ()), ("gauge", "occupancy", ("bucket", "lane")),
            ("histogram", "latency_seconds", ()), ("histogram", "size", ("op",))]
    out = []
    for _ in range(n):
        kind, name, labels = fams[rng.integers(len(fams))]
        values = tuple(f"v{rng.integers(3)}\"\n\\" if rng.random() < 0.1 else f"v{rng.integers(3)}"
                       for _ in labels)
        if kind == "counter":
            method, value = "inc", float(rng.choice([1.0, 0.5, rng.random() * 100]))
        elif kind == "gauge":
            method = rng.choice(["set", "inc", "dec"])
            value = float(rng.choice([3.0, -2.25, rng.random() * 1e6, 1e20]))
        else:
            method, value = "observe", float(10.0 ** rng.uniform(-5, 2))
        out.append((kind, name, labels, values, str(method), value))
    return out


def _apply(registry, ops):
    for kind, name, labels, values, method, value in ops:
        fam = getattr(registry, kind)(name, f"help of {name}", labels=labels)
        child = fam.labels(*values) if labels else fam
        getattr(child, method)(value)
    return registry.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exporters_give_jaxs_bytes(seed):
    ops = _ops(seed)
    got, want = _apply(MetricsRegistry(), ops), _apply(JRegistry(), ops)
    assert got == want
    assert to_prometheus(got) == jexport.to_prometheus(want)
    assert to_json(got, run="x") == jexport.to_json(want, run="x")
    assert snapshot_digest(got) == jexport.snapshot_digest(want)


def test_registry_semantics_match_jaxs():
    for reg in (MetricsRegistry(), JRegistry()):
        c = reg.counter("c_total", "h")
        with pytest.raises(ValueError, match="counters only go up"):
            c.inc(-1)
        with pytest.raises(ValueError, match="re-declared"):
            reg.gauge("c_total")
        with pytest.raises(ValueError, match="bad metric name"):
            reg.counter("1bad")
        g = reg.gauge("g", labels=("a",))
        with pytest.raises(ValueError, match="use .labels"):
            g.set(1)
        assert reg.counter("c_total", "h") is c


def test_write_exporters_atomically(tmp_path):
    reg = MetricsRegistry()
    _apply(reg, _ops(5, 20))
    p = export.write_prometheus(reg, str(tmp_path / "m" / "out.prom"))
    assert Path(p).read_text() == to_prometheus(reg.snapshot())
    j = export.write_json(reg, str(tmp_path / "out.json"), run="r")
    assert json.loads(Path(j).read_text())["run"] == "r"
    assert not list(tmp_path.rglob("*.tmp"))


def _timeline():
    tl = Timeline()
    with tl.span("chunk", index=1) as sp:
        sp.annotate(extra=2)
    tl.complete("compile", time.perf_counter(), 0.01, cat="compile")
    tl.instant("seal", track="bucket:x", jobs=3)
    tl.counter("depth", {"q": 1})
    tl.flow_start("job:a", "a", track="intake")
    tl.flow_step("job:a", "a", track="bucket:x")
    tl.flow_end("job:a", "a", track="bucket:x")
    try:
        with tl.span("boom"):
            raise KeyError("x")
    except KeyError:
        pass
    return tl


def test_timelines_pass_both_validators(tmp_path):
    tl = _timeline()
    data = json.loads(Path(tl.write(str(tmp_path / "t.json"))).read_text())
    got = validate_trace(data, require_spans=["chunk", "compile"], require_balanced_flows=True)
    assert got == jvalidate(data, require_spans=["chunk", "compile"],
                            require_balanced_flows=True)
    assert got["span_names"] == {"boom": 1, "chunk": 1, "compile": 1}
    errored = [e for e in data["traceEvents"] if e.get("name") == "boom"]
    assert errored[0]["args"]["error"] == "KeyError"
    assert NULL.span("x") is NULL.span("y") and len(NULL) == 0
    with pytest.raises(RuntimeError):
        NULL.write(str(tmp_path / "n.json"))


def _bad(mutate):
    data = _timeline().to_dict()
    mutate(data)
    return data


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("traceEvents"),
    lambda d: d.update(traceEvents=[]),
    lambda d: d["traceEvents"].append({"ph": "Q", "pid": 1, "tid": 1, "name": "x"}),
    lambda d: d["traceEvents"].append({"ph": "X", "pid": 1, "tid": 1, "name": "x", "ts": -1}),
    lambda d: d["traceEvents"].append({"ph": "X", "pid": 1, "tid": 1, "name": "x", "ts": 1}),
    lambda d: d["traceEvents"].append({"ph": "s", "pid": 1, "tid": 1, "name": "x", "ts": 1}),
    lambda d: d["traceEvents"].append({"ph": "C", "pid": 1, "tid": 1, "name": "x", "ts": 1}),
    lambda d: d["traceEvents"].append({"ph": "i", "pid": "1", "tid": 1, "name": "x", "ts": 1}),
])
def test_validator_rejects_what_jaxs_rejects(mutate):
    data = _bad(mutate)
    with pytest.raises(JTraceError) as jerr:
        jvalidate(data)
    with pytest.raises(TraceError) as terr:
        validate_trace(data)
    assert str(terr.value) == str(jerr.value)


def test_check_trace_cli(tmp_path):
    path = _timeline().write(str(tmp_path / "t.json"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.check_trace", path,
                          "--require-span", "chunk"], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("OK")


# -- the engine ---------------------------------------------------------------------


def _engines(params, obs=None, jobs=None, **cfg):
    cfg = dict(dict(n_replicas=R, swap_interval=2, chunk_intervals=2), **cfg)
    jsys, tsys = jsystems.make_system("ising", params), tsystems.make_system("ising", params)
    return (JEngine(jsys, JEngineConfig(**cfg), obs=jobs),
            Engine(tsys, EngineConfig(**cfg), device="cpu", obs=obs))


def test_engine_metric_families_are_jaxs():
    tobs, jobs = Observability.create(), JObservability.create()
    jeng, teng = _engines({"length": 4}, obs=tobs, jobs=jobs)
    teng.run(teng.init(keys.key(1), TEMPS), 8)
    jeng.run(jeng.init(jax.random.key(1), TEMPS), 8)
    tsnap, jsnap = tobs.metrics.snapshot(), jobs.metrics.snapshot()
    assert {k: (v["type"], v["help"], v["label_names"]) for k, v in tsnap.items()} == \
        {k: (v["type"], v["help"], v["label_names"]) for k, v in jsnap.items()}
    value = lambda n: tsnap[n]["samples"][0]["value"]  # noqa: E731
    assert value("engine_compiles_total") == 1 and value("engine_chunks_total") == 2
    assert value("engine_sweeps_total") == 8
    # the rung gauges read the same pooled counters as JAX's
    assert tsnap["pt_swap_acceptance"] == jsnap["pt_swap_acceptance"]
    names = {e["name"] for e in tobs.timeline.events() if e["ph"] == "X"}
    assert {"compile", "device_wait", "chunk"} <= names


def test_obs_off_engine_never_touches_obs_layer(monkeypatch):
    def bomb(*a, **k):
        raise AssertionError("obs layer touched on the obs-off path")

    monkeypatch.setattr(tdriver._EngineObs, "__init__", bomb)
    for meth in ("span", "complete", "instant", "counter"):
        monkeypatch.setattr(ttimeline.Timeline, meth, bomb)
    for name in ("counter", "gauge", "histogram"):
        monkeypatch.setattr(tmetrics.MetricsRegistry, name, bomb)
    _, eng = _engines({"length": 4, "use_fused": True, "use_fused_round": True})
    assert eng.obs is None
    _, res = eng.run(eng.init(keys.key(0), TEMPS), 8)
    assert res.n_sweeps == 8


@pytest.mark.parametrize("path", ["sweep", "fused", "round"])
def test_obs_on_and_off_give_equal_results_and_launches(path):
    params = {"length": 4, "use_fused": path != "sweep", "use_fused_round": path == "round"}
    out = []
    for obs in (None, Observability.create(timeline=True)):
        _, eng = _engines(params, obs=obs, n_chains=2)
        build.reset_launches()
        st, res = eng.run(eng.init(keys.key(5), TEMPS), 12)
        out.append((st, res, dict(build.launches)))
    (a, ra, la), (b, rb, lb) = out
    assert la == lb  # the plain versions count no launch: equal at zero
    for x, y in zip((a.pt.states, a.pt.energy, a.pt.rung), (b.pt.states, b.pt.energy, b.pt.rung)):
        assert torch.equal(x, y)
    for k in ra.summary:
        assert np.array_equal(ra.summary[k], rb.summary[k])


@pytest.mark.parametrize("params, cfg, want", [
    # round path: a launch an interval reads and writes each lattice once
    ({"length": 8, "use_fused": True, "use_fused_round": True},
     dict(n_replicas=4, swap_interval=10, chunk_intervals=3, n_chains=2), 2.0 * 64 * 3 * 4 * 2),
    # per sweep: 2 f32 uniform planes written and read, the lattice in and out
    ({"length": 8}, dict(n_replicas=4, swap_interval=10, chunk_intervals=3), 18.0 * 64 * 30 * 4),
])
def test_modeled_hbm_bytes_model_the_ports_kernels(params, cfg, want):
    eo = tdriver._EngineObs(Observability.create(timeline=False),
                            tsystems.make_system("ising", params), EngineConfig(**cfg))
    assert eo.hbm_bytes == want


def test_potts_and_latticeless_hbm_model():
    potts = tsystems.make_system("potts", {"shape": (4, 6), "q": 3})
    cfg = EngineConfig(n_replicas=2, swap_interval=5, chunk_intervals=2)
    eo = tdriver._EngineObs(Observability.create(timeline=False), potts, cfg)
    assert eo.hbm_bytes == 34.0 * 24 * 10 * 2
    gauss = tsystems.make_system("gaussian", {})
    assert tdriver._EngineObs(Observability.create(timeline=False), gauss, cfg).hbm_bytes is None


def test_torch_profile_window_writes_one_trace_and_a_failure_is_an_instant(tmp_path,
                                                                           monkeypatch):
    obs = Observability.create(timeline=True, torch_profile_dir=str(tmp_path / "prof"))
    _, eng = _engines({"length": 4}, obs=obs)
    eng.run(eng.init(keys.key(2), TEMPS), 8)
    assert (tmp_path / "prof" / "torch_profile.trace.json").is_file()
    assert obs.torch_profile_dir is None  # one chunk, ever
    names = [e["name"] for e in obs.timeline.events()]
    assert names.count("torch_profile_start") == 1 and names.count("torch_profile_stop") == 1

    def refuse(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    obs = Observability.create(timeline=True, torch_profile_dir=str(tmp_path / "p2"))
    _, eng = _engines({"length": 4}, obs=obs)
    _, res = eng.run(eng.init(keys.key(2), TEMPS), 8)
    assert res.n_sweeps == 8
    failed = [e for e in obs.timeline.events() if e["name"] == "torch_profile_failed"]
    assert len(failed) == 1 and "no profiler here" in failed[0]["args"]["error"]


def test_obs_callback_through_a_session(tmp_path):
    spec = RunSpec.from_json((SPECS / "ising_small_fused.json").read_text())
    cb = ObsCallback(timeline_path=str(tmp_path / "t.json"),
                     metrics_path=str(tmp_path / "m.prom"))
    res = Session(spec, callbacks=[cb], device="cpu").run()
    bare = Session(spec, device="cpu").run()
    assert res.manifest() == bare.manifest()
    summary = validate_trace(json.loads((tmp_path / "t.json").read_text()),
                             require_spans=["chunk", "compile"])
    assert any(n.startswith("phase:") for n in summary["span_names"])
    assert "engine_chunks_total" in (tmp_path / "m.prom").read_text()


def test_cli_run_with_obs_flags(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", str(SPECS / "ising_small.json"),
         "--device", "cpu", "--out", str(tmp_path / "run"), "--timeline",
         str(tmp_path / "run.trace.json"), "--metrics-out", str(tmp_path / "run.prom"),
         "--torch-profile", str(tmp_path / "prof"), "--strict-kernels", "--quiet"],
        capture_output=True, text=True, env={"PYTHONPATH": str(ROOT / "src")}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "run" / "manifest.json").is_file()
    validate_trace(json.loads((tmp_path / "run.trace.json").read_text()),
                   require_spans=["compile", "chunk", "checkpoint"])
    assert "engine_sweeps_total" in (tmp_path / "run.prom").read_text()
    assert (tmp_path / "prof" / "torch_profile.trace.json").is_file()


def test_scheduler_metrics_and_lanes():
    spec = RunSpec.from_json((SPECS / "ising_serve.json").read_text())
    obs = Observability.create(timeline=True)
    sched = Scheduler(device="cpu", obs=obs)
    for s in range(2):
        sched.submit(spec.__class__.from_dict({**spec.to_dict(), "seed": s}))
    sched.run_until_idle()
    snap = sched.metrics()
    assert snap["serve_quanta_total"]["samples"][0]["value"] == 4
    assert snap["serve_jobs_packed_per_compile"]["samples"][0]["value"] == 2
    assert snap["engine_compiles_total"]["samples"][0]["value"] == 1
    summary = validate_trace(obs.timeline.to_dict(), require_spans=["quantum", "chunk"],
                             require_balanced_flows=True)
    assert any(t.startswith("bucket:") for t in summary["tracks"])
    bare = Scheduler(device="cpu")
    bare.submit(spec)
    bare.run_until_idle()
    assert bare.metrics()["serve_quanta_total"]["samples"][0]["value"] == 4
