"""The port stands alone, starts from the CLI, and refuses what it lacks.

* no module of ``src/repro_torch``, not ``chip_smoke.py`` and not the mesh
  tests' rank script ``tests/_torch_mesh_child.py`` imports ``jax`` or the
  JAX package ``repro`` (AST scan);
* importing the port initializes no CUDA state and builds nothing;
* ``python -m repro_torch run ... --device cpu`` writes a manifest,
  ``python -m repro_torch validate ising --device cpu`` passes, and
  ``--device cuda`` without a card fails instead of running on the CPU;
* a ``mesh`` spec without the ranks it needs fails with the "needs N ranks"
  `ValueError` naming the launcher, and specs an earlier slice refused now
  run (a one-rank mesh among them);
* a state on another device than its engine's, or a carried state asked
  for on a missing card, is refused instead of running elsewhere;
* kernels build inside the source checkout (or where
  ``$REPRO_TORCH_BUILD_DIR`` says), never beside an installed copy;
* ``chip_smoke.py`` exits non-zero and prints no result without a card, and
  when it stands alone in a directory;
* running the reduced RWKV-6 model on the CPU through ``launch.serve_lm``
  builds no kernel, touches no CUDA state and imports no JAX or ``repro``.
"""
import dataclasses
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.api import RunSpec, Session  # noqa: E402
from repro_torch.core import keys  # noqa: E402
from repro_torch.core.ising import IsingSystem  # noqa: E402
from repro_torch.engine import AdaptConfig, Engine, EngineConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SPECS = ROOT / "examples" / "specs"
FORBIDDEN = ("jax", "repro", "jaxlib")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "tests" / "_torch_mesh_child.py"]
    assert {"distributed.py", "sample.py"} <= {f.name for f in files}
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_import_touches_no_cuda_and_builds_nothing():
    code = (
        "import torch, importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import sys\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(k.startswith(('jax', 'repro.')) or k == 'repro' for k in sys.modules)\n"
        "from repro_torch.kernels import build\n"
        "assert not build._LOADED\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cli_run_on_cpu_writes_manifest(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", str(SPECS / "ising_small_fused.json"),
         "--device", "cpu", "--out", str(tmp_path), "--quiet"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stderr
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["final"]["sweep"] == 800
    assert set(manifest["phases"]) == {"burn", "measure"}
    assert len(manifest["final"]["energy"]) == 8


def test_cli_validate_on_cpu_passes_and_refuses_unported_systems(tmp_path):
    """``python -m repro_torch validate ising --device cpu`` runs the zoo's
    Ising entry (per-sweep path) against its exact answers and exits 0; a
    system the zoo lacks is refused by name with exit code 2 (the port now
    runs all five of the JAX zoo's systems)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "validate", "ising", "--device", "cpu",
         "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=tmp_path,
    )
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout and "ladder retuned 2x" in out.stdout
    report = json.loads((tmp_path / "validate_ising.json").read_text())
    assert report["device"] == "cpu" and len(report["temps"]) == 5
    refused = subprocess.run(
        [sys.executable, "-m", "repro_torch", "validate", "nonesuch", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert refused.returncode == 2
    assert "unknown system 'nonesuch'" in refused.stderr


def test_cli_list_systems():
    out = subprocess.run([sys.executable, "-m", "repro_torch", "list-systems"],
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    for name in ("ising", "gaussian", "potts", "ea_spin_glass", "hp_protein"):
        assert f"{name}: observables" in out.stdout


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    spec = RunSpec.from_json((SPECS / "ising_small_fused.json").read_text())
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        Session(spec)  # the default device is cuda
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", str(SPECS / "ising_small_fused.json"),
         "--device", "cuda", "--out", str(tmp_path), "--quiet"],
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and "CUDA was requested" in out.stderr
    assert not (tmp_path / "manifest.json").exists()


def _spec(**edits):
    d = json.loads((SPECS / "ising_small_fused.json").read_text())
    for path, value in edits.items():
        node = d
        *parents, leaf = path.split("__")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return RunSpec.from_json(d)


@pytest.mark.parametrize("edits,missing", [
    ({"engine__mesh": {"ensemble": 1, "replica": 2}}, "mesh"),
])
def test_unported_specs_are_refused_by_name(edits, missing):
    """A mesh spec was refused as not ported until the multi-device slice;
    now it runs, and in one process with no 2-rank group it fails naming
    the ranks it needs and the launcher that starts them."""
    with pytest.raises(ValueError, match="needs 2 ranks") as err:
        Session(_spec(**edits), device="cpu")
    assert missing in str(err.value)
    assert "torchrun --nproc-per-node 2" in str(err.value)


@pytest.mark.parametrize("edits", [
    {"system__params__use_fused": False},
    {"system__name": "potts", "system__params": {"shape": [4, 4], "q": 3},
     "observables": ["pmag"]},
    {"system__params__use_fused": False, "system__params__pack_bits": True},
    {"engine__n_chains": 2},
    {"system__params__pack_bits": True},
    {"engine__swap_mode": "state"},
    {"exchange__strategy": "windowed"},
    {"exchange__strategy": "vmpt"},
    {"exchange__strategy": "seo"},
    {"adapt__mode": "flow"},
    {"system__params__update": "single_flip", "system__params__use_fused": False},
    {"engine__mesh": {"ensemble": 1, "replica": 1}},
], ids=["per-sweep", "potts", "per-sweep-pack_bits", "n_chains=2", "fused-pack_bits",
        "swap_mode=state", "windowed", "vmpt", "seo-strategy-path", "adapt-flow",
        "single_flip", "mesh-1x1"])
def test_specs_refused_before_now_run(edits):
    """The per-sweep default path and Potts, then ``pack_bits`` (ignored on
    the per-sweep path) and the ensemble axis, then state-mode swaps, the
    SEO, windowed and VMPT strategies on the strategy path (this spec's
    interval-fused path) and flow adaptation, then ``update="single_flip"``
    (per-sweep path: the fused kernels sweep checkerboards), then a mesh
    were refused by name; they now build and run a few sweeps on the CPU (in
    state mode the rung map is the identity, a permutation too; a one-rank
    mesh on a one-rank gloo group)."""
    session = Session(_spec(**edits), device="cpu")
    state, result = session.engine.run(session.init_state(), 20)
    chains = session.spec.engine.n_chains
    assert result.n_sweeps == 20
    assert state.pt.t.tolist() == (20 if chains == 1 else [20] * chains)
    assert bool(torch.isfinite(state.pt.energy).all())
    rungs = state.pt.rung.reshape(chains, -1)
    assert all(sorted(r.tolist()) == list(range(8)) for r in rungs)


def test_tpu_knobs_are_accepted_and_ignored():
    a = IsingSystem(length=4, use_fused=True, use_pallas=True, r_blk=3)
    assert a.use_pallas and a.r_blk == 3
    assert AdaptConfig(mode="flow").mode == "flow"  # ported: no longer refused


@pytest.mark.parametrize("method", ["run", "reset_stats"])
@pytest.mark.parametrize("field", ["states", "betas"])
def test_engine_refuses_a_state_on_another_device(method, field):
    eng = Engine(IsingSystem(length=4, use_fused=True),
                 EngineConfig(n_replicas=4, swap_interval=2), device="cpu")
    st = eng.init(keys.key(1), np.linspace(1.0, 3.0, 4))
    if field == "states":
        st = dataclasses.replace(st, pt=dataclasses.replace(
            st.pt, states=st.pt.states.to("meta")))
    else:
        st = dataclasses.replace(st, betas=st.betas.to("meta"))
    args = (st, 2) if method == "run" else (st,)
    with pytest.raises(ValueError, match=f"{field} is on meta but the engine runs on cpu"):
        getattr(eng, method)(*args)


def test_carry_asked_for_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    arrays = {"states": np.ones((2, 4, 4), np.int8), "energy": np.zeros(2, np.float32),
              "rung": np.arange(2, dtype=np.int32), "key": np.array([0, 5], np.uint32),
              "t": np.array(0), "phase": np.array(0)}
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        carry.from_reference(arrays, "cuda")
    assert carry.from_reference(arrays, "cpu").states.device.type == "cpu"


@pytest.mark.parametrize("where", ["checkout", "env", "installed"])
def test_kernel_build_dir(where, tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    if where == "checkout":
        assert build.build_root() == ROOT / "build" / "repro_torch"
    elif where == "env":
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
        assert build.build_root() == tmp_path / "b"
    else:
        monkeypatch.setattr(build, "_PKG", tmp_path / "site-packages" / "repro_torch")
        with pytest.raises(RuntimeError, match="REPRO_TORCH_BUILD_DIR"):
            build.build_root()


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_chip_smoke(tmp_path)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
    if not torch.cuda.is_available():
        here = _run_chip_smoke(ROOT)
        assert here.returncode != 0 and '"ok"' not in here.stdout


def test_lm_modules_touch_no_cuda_and_build_nothing():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import serve_lm\n"
        "from repro_torch.models import model\n"
        "from repro_torch.kernels import build\n"
        "cfg = get_config('rwkv6_7b', reduced=True)\n"
        "out = serve_lm.generate(model.init_params(cfg, 0, device='cpu'), cfg, 2, 2, 'cpu')\n"
        "assert tuple(out.shape) == (2, 3) and not build._LOADED\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(k.startswith(('jax', 'repro.')) or k == 'repro' for k in sys.modules)\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
