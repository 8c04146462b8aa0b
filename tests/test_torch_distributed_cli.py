"""The port's CLI on a mesh under torchrun, against the JAX CLI (the
multi-process half of tests/test_torch_distributed.py is in
tests/test_torch_distributed_ranks.py).

``torchrun --nproc-per-node 2 -m repro_torch run ... --mesh-replicas 2
--device cpu`` brings up a gloo group from RANK/WORLD_SIZE/LOCAL_RANK;
rank 0 alone writes the manifest, which must equal the one the JAX CLI
writes unsharded.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def test_torchrun_cli_writes_the_unsharded_jax_manifest(tmp_path):
    from repro.api import cli as jcli

    from test_torch_engine import _assert_manifests_match

    # examples/specs/ising_small.json (adaptation, two observables) cut to
    # 100 + 100 sweeps
    data = json.loads((ROOT / "examples" / "specs" / "ising_small.json").read_text())
    for phase in data["schedule"]["phases"]:
        phase["n_sweeps"] = 100
    spec = str(tmp_path / "ising_small_cut.json")
    Path(spec).write_text(json.dumps(data))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch", "run", spec, "--mesh-replicas", "2", "--device", "cpu",
         "--out", str(tmp_path / "port"), "--quiet"],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("manifest.json") == 1  # rank 0 alone writes
    assert jcli.main(["run", spec, "--out", str(tmp_path / "jax"), "--quiet"]) == 0
    tm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert tm["spec"]["engine"]["mesh"] == {"ensemble": 1, "replica": 2}
    _assert_manifests_match(json.loads((tmp_path / "jax" / "manifest.json").read_text()), tm)
