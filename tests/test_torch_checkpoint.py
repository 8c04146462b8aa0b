"""The port's checkpoints and resume against the JAX package.

* Format: the port's leaf table (`repro_torch.checkpoint.engine_leaves`)
  writes exactly the names, dtypes and shapes JAX's ``_flatten`` writes
  for the same state, with one chain and with two;
* the manager: a round trip, a flipped byte (sha256 mismatch), a torn
  file, the newest-first fallback past one bad generation, retention that
  keeps the last intact step, an all-corrupt directory, concurrent child
  managers, ``save_spec`` / ``load_spec`` and an async save;
* cross-resume: a JAX Session checkpointed mid-burn (adaptation on, by an
  ``EarlyStopCallback``) and resumed by the port's
  ``Session.from_checkpoint(device="cpu")`` equals the uninterrupted JAX
  run, and a port checkpoint resumed by JAX equals the uninterrupted port
  run, on the interval-fused, round and per-sweep paths;
* the CLI: ``resume`` writes the manifest JAX's ``resume`` writes, then
  says there is nothing to resume; ``list-strategies`` prints what JAX's
  prints; ``run`` checkpoints into ``OUT/checkpoints``.

Tolerances: spins, rungs, counters, key words, the sweep counter and the
final ladder (f64 in the meta) are exact; energies are integers here
(j=1, b=0) and exact; Welford means within 1e-6 relative (XLA's and
torch's op order, test_torch_engine).
"""
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.api import CheckpointCallback as JCheckpointCallback  # noqa: E402
from repro.api import EarlyStopCallback as JEarlyStop  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import Session as JSession  # noqa: E402
from repro.checkpoint.manager import _flatten  # noqa: E402
from repro.core import systems as jsystems  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.api import CheckpointCallback, EarlyStopCallback  # noqa: E402
from repro_torch.api import RunSpec as TRunSpec  # noqa: E402
from repro_torch.api import Session as TSession  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorrupt,
    CheckpointManager,
    to_arrays,
)
from repro_torch.core import keys as tkeys  # noqa: E402
from repro_torch.core import systems as tsystems  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine import EngineConfig as TEngineConfig  # noqa: E402

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"
OBS = ("absmag", "energy_per_site")


def _engines(n_chains, system="ising", params=None):
    params = params or {"length": 4, "use_fused": True}
    js, ts = jsystems.make_system(system, params), tsystems.make_system(system, params)
    obs = OBS if system == "ising" else ("pmag",)
    cfg = dict(n_replicas=3, swap_interval=2, n_chains=n_chains)
    jeng = JEngine(js, JEngineConfig(donate=False, **cfg),
                   observables=jsystems.named_observables(system, js, obs))
    teng = TEngine(ts, TEngineConfig(**cfg),
                   observables=tsystems.named_observables(system, ts, obs), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("system", ["ising", "potts"])
@pytest.mark.parametrize("n_chains", [1, 2])
def test_leaf_table_matches_jax_flatten(n_chains, system):
    params = None if system == "ising" else {"shape": (4, 6), "q": 3, "use_fused": True}
    jeng, teng = _engines(n_chains, system, params)
    temps = np.linspace(1.0, 2.0, 3)
    want = _flatten(jeng.init(jax.random.key(5), temps))
    got = to_arrays(teng.init(tkeys.key(5), temps))
    assert list(got) == list(want)  # names, in JAX's order
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _state(seed=1):
    _, teng = _engines(1)
    st = teng.init(tkeys.key(seed), np.linspace(1.0, 2.0, 3))
    st, _ = teng.run(st, 4)
    return teng, st


def _assert_same(a, b):
    ta, tb = to_arrays(a), to_arrays(b)
    assert list(ta) == list(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def test_round_trip_and_restore_device(tmp_path):
    teng, st = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, st, meta={"note": "x"})
    got, meta = teng.restore(mgr)
    _assert_same(got, st)
    assert meta["note"] == "x" and meta["step"] == 4
    assert got.pt.t.dtype == torch.int64 and got.pt.key.dtype == torch.int64
    assert got.pt.t.device.type == "cpu"
    arrays = dict(np.load(tmp_path / "step_0000000004" / "arrays_p0.npz"))
    _assert_same(carry.from_checkpoint_arrays(arrays, "cpu"), st)
    assert mgr.last_restore_fallback == 0


@pytest.mark.parametrize("damage", [_flip_byte, _truncate], ids=["sha256", "torn"])
def test_damaged_newest_step_falls_back_one_generation(tmp_path, damage):
    teng, st = _state()
    st2, _ = teng.run(st, 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, st)
    mgr.save(6, st2)
    path = tmp_path / "step_0000000006" / "arrays_p0.npz"
    damage(path)
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(6, st)
    got, meta = teng.restore(mgr)
    assert meta["step"] == 4 and mgr.last_restore_fallback == 1
    _assert_same(got, st)


def test_gc_keeps_the_last_intact_step(tmp_path):
    teng, st = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(2, st)
    mgr.save(4, st)
    _truncate(tmp_path / "step_0000000004" / "arrays_p0.npz")
    mgr.save(6, st)  # GC counts readable steps only: 2 and 6 stay, torn 4 goes
    assert mgr.steps() == [2, 6]
    _truncate(tmp_path / "step_0000000006" / "arrays_p0.npz")
    mgr.save(8, st)
    assert mgr.steps() == [2, 8]
    _, meta = teng.restore(mgr)
    assert meta["step"] == 8


def test_all_corrupt_raises_and_empty_is_none(tmp_path):
    teng, st = _state()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert teng.restore(mgr) is None
    mgr.save(2, st)
    mgr.save(4, st)
    for step in (2, 4):
        _flip_byte(tmp_path / "ck" / f"step_{step:010d}" / "arrays_p0.npz")
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        teng.restore(mgr)
    assert mgr.last_restore_fallback == 2


def test_concurrent_child_managers_and_async_save(tmp_path):
    teng, st = _state()
    root = CheckpointManager(str(tmp_path), keep=2)
    children = [root.child(f"job{i}") for i in range(4)]
    same = [CheckpointManager(str(tmp_path / "shared"), keep=2) for _ in range(4)]
    errors = []

    def work(mgr):
        try:
            for step in range(1, 6):
                mgr.save(step, st)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(m,)) for m in children + same]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for mgr in children + same[:1]:
        assert mgr.steps() == [4, 5]
        got, meta = teng.restore(mgr)
        assert meta["step"] == 5
        _assert_same(got, st)
    assert not [p for p in os.listdir(tmp_path / "shared") if p.endswith(".tmp")]
    mgr = CheckpointManager(str(tmp_path / "async"))
    mgr.save_spec({"a": 1})
    mgr.save(7, st, blocking=False)
    mgr.wait()
    assert mgr.load_spec() == {"a": 1} and mgr.steps() == [7]
    with pytest.raises(ValueError):
        mgr.save_spec("not json")


def _spec_dict(path):
    d = json.loads((SPECS / "ising_small_fused.json").read_text())
    d["system"]["params"].update(length=6, use_pallas=False, use_fused=path != "sweep",
                                 use_fused_round=path == "round")
    d["ladder"]["n_replicas"] = 6
    d["engine"] = {"swap_interval": 5, "chunk_intervals": 4}
    d["adapt"] = {"target": 0.3, "min_attempts_per_pair": 3, "max_rounds": 3}
    d["schedule"]["phases"] = [{"name": "burn", "n_sweeps": 120, "adapt": True},
                               {"name": "measure", "n_sweeps": 60, "reset_stats": True}]
    return d


STOP = 80  # mid-burn, after the first retunes


def _assert_resumed_equal(full, resumed):
    """``full``, ``resumed``: (manifest, final state as numpy dict)."""
    (fm, fs), (rm, rs) = full, resumed
    assert fm["final"]["sweep"] == rm["final"]["sweep"]
    assert fm["final"]["temps"] == rm["final"]["temps"]  # exact: the f64 meta ladder
    assert fm["final"]["energy"] == rm["final"]["energy"]
    for k in ("states", "rung", "energy", "key", "t", "phase", "swap_attempts",
              "swap_accepts", "round_trips", "up_visits", "labeled_visits", "direction",
              "n_records"):
        np.testing.assert_array_equal(rs[k], fs[k].astype(rs[k].dtype), err_msg=k)
    for k in ("mean_energy", "mean_absmag"):
        np.testing.assert_allclose(rm["phases"]["measure"]["summary"][k],
                                   fm["phases"]["measure"]["summary"][k], rtol=1e-6, atol=0)
    # the resumed burn re-entered the checkpointed adaptation window
    assert rm["phases"]["burn"]["ladder_history"][-1] == fm["phases"]["burn"]["ladder_history"][-1]


def _jnp(res):
    pt, stats = res.state.pt, res.state.stats
    out = {k: np.asarray(getattr(pt, k)) for k in ("states", "rung", "energy", "t", "phase")}
    out["key"] = np.asarray(jax.random.key_data(pt.key))
    for k in ("swap_attempts", "swap_accepts", "round_trips", "up_visits",
              "labeled_visits", "direction", "n_records"):
        out[k] = np.asarray(getattr(stats, k))
    return res.manifest(), out


def _tnp(res):
    pt, stats = res.state.pt, res.state.stats
    out = {k: getattr(pt, k).numpy() for k in ("states", "rung", "energy", "t", "phase", "key")}
    for k in ("swap_attempts", "swap_accepts", "round_trips", "up_visits",
              "labeled_visits", "direction", "n_records"):
        out[k] = getattr(stats, k).numpy()
    return res.manifest(), out


@pytest.mark.parametrize("path", ["fused", "round", "sweep"])
def test_jax_checkpoint_resumed_by_the_port(tmp_path, path):
    d = _spec_dict(path)
    full = JSession(JRunSpec.from_json(d)).run()
    part = JSession(JRunSpec.from_json(d), callbacks=[
        JCheckpointCallback(str(tmp_path)), JEarlyStop(lambda i: i.sweeps_done >= STOP)]).run()
    assert part.stopped_early and int(part.state.pt.t) == STOP
    session = TSession.from_checkpoint(str(tmp_path), device="cpu")
    assert session.remaining_sweeps == 180 - STOP
    resumed = session.run()
    assert list(resumed.phases) == ["burn", "measure"]
    _assert_resumed_equal(_jnp(full), _tnp(resumed))


@pytest.mark.parametrize("path", ["fused", "round", "sweep"])
def test_port_checkpoint_resumed_by_jax(tmp_path, path):
    d = _spec_dict(path)
    full = TSession(TRunSpec.from_json(d), device="cpu").run()
    part = TSession(TRunSpec.from_json(d), device="cpu", callbacks=[
        CheckpointCallback(str(tmp_path / "a")),
        EarlyStopCallback(lambda i: i.sweeps_done >= STOP)]).run()
    assert part.stopped_early and int(part.state.pt.t) == STOP
    shutil.copytree(tmp_path / "a", tmp_path / "b")  # each resume checkpoints on
    resumed = JSession.from_checkpoint(str(tmp_path / "a")).run()
    _assert_resumed_equal(_tnp(full), _jnp(resumed))
    # and the port resumes its own checkpoint to the same state
    again = TSession.from_checkpoint(str(tmp_path / "b"), device="cpu").run()
    _assert_resumed_equal(_tnp(full), _tnp(again))


def test_cli_resume_and_list_strategies_match_jax(tmp_path, capsys):
    from repro.api import cli as jcli
    from repro_torch.api import cli as tcli

    d = _spec_dict("fused")
    for who in ("jax", "port"):
        out = tmp_path / who
        TSession(TRunSpec.from_json(d), device="cpu", callbacks=[
            CheckpointCallback(str(out / "checkpoints")),
            EarlyStopCallback(lambda i: i.sweeps_done >= STOP)]).run()
    assert jcli.main(["resume", str(tmp_path / "jax"), "--quiet"]) == 0
    assert tcli.main(["resume", str(tmp_path / "port"), "--device", "cpu", "--quiet"]) == 0
    jm = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert jm["final"] == tm["final"] and jm["phases"].keys() == tm["phases"].keys()
    for name in jm["phases"]:
        assert jm["phases"][name]["ladder_history"] == tm["phases"][name]["ladder_history"]
    capsys.readouterr()
    assert tcli.main(["resume", str(tmp_path / "port"), "--device", "cpu", "--quiet"]) == 0
    assert "nothing to resume" in capsys.readouterr().err
    assert jcli.main(["list-strategies"]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["list-strategies"]) == 0
    assert capsys.readouterr().out == want and "windowed" in want


def test_cli_run_checkpoints_and_resume_continues(tmp_path):
    from repro_torch.api import cli as tcli

    spec = tmp_path / "spec.json"
    d = _spec_dict("fused")
    spec.write_text(json.dumps(d))
    assert tcli.main(["run", str(spec), "--device", "cpu", "--out", str(tmp_path / "a"),
                      "--checkpoint-every", "2", "--quiet"]) == 0
    steps = CheckpointManager(str(tmp_path / "a" / "checkpoints")).steps()
    assert steps[-1] == 180 and len(steps) == 3  # keep=3
    first = json.loads((tmp_path / "a" / "manifest.json").read_text())
    TSession(TRunSpec.from_json(d), device="cpu", callbacks=[
        CheckpointCallback(str(tmp_path / "c" / "checkpoints")),
        EarlyStopCallback(lambda i: i.sweeps_done >= STOP)]).run()
    assert tcli.main(["resume", str(tmp_path / "c"), "--device", "cpu", "--quiet"]) == 0
    assert json.loads((tmp_path / "c" / "manifest.json").read_text())["final"] == first["final"]
