"""Fault-tolerant checkpoints in the JAX package's format (twin of
`repro.checkpoint.manager`).

Layout: ``<dir>/step_<N:010d>/arrays_p<proc>.npz`` + ``meta.json``, staged in
``step_N.<pid>-<n>.tmp`` and renamed into place, and ``<dir>/spec.json``
(`save_spec`).  Either package reads the other's checkpoints:

* the npz names are the JAX ``keystr`` paths of an ``EngineState``
  (``.pt.states``, ``.stats.mean['energy']``, ``.betas``, ...) in JAX's
  flatten order, written from the fixed table `engine_leaves`;
* the stored dtypes are JAX's: the key as its two ``key_data`` words
  (``(2,)`` or ``(C, 2)`` uint32), ``t`` and ``phase`` int32 (the port holds
  them in int64), the rest as the port holds them;
* the system's state is one leaf ``.pt.states`` in its own dtype (Ising and
  Potts int8 lattices, HP's ``(R, N, 2)`` int32 chains, the Gaussian's
  ``(R,)`` f32) or, for a dict state, one leaf per key in sorted order
  (EA: ``.pt.states['jd']``, ``['jr']`` f32 and ``['spins']`` int8), as
  JAX flattens its pytree;
* every staged file's sha256 and byte count land in the step's
  ``meta.json`` (``integrity``) and are checked on restore
  (`CheckpointCorrupt`);
* `restore_latest` walks the steps newest first past unreadable ones
  (``last_restore_fallback`` counts them) and raises when every step is
  unreadable; retention keeps the newest ``keep`` *readable* steps;
* staging directories are unique and the final rename is serialized per
  directory, so managers in one process never clobber each other; `child`
  roots a manager in a subdirectory;
* ``save(..., blocking=False)`` copies the tensors to the host first, then
  writes on a thread (one outstanding write; `wait` joins it);
* a `repro_torch.resilience.FaultPlan` given as ``faults`` tears, corrupts
  or crashes a write at the JAX manager's seams.

A tree is the port's ``EngineState`` or a training state
(`repro_torch.train.train_step.TrainState`).  A training state's leaves
take JAX's ``keystr`` names too (`train_to_arrays`): ``.params['embed']``,
``.params['groups']['0_rwkv']['tm']['w_r']`` with the layers stacked on a
leading axis as JAX's scanned groups hold them (each group of the layer
plan, ``['tail'][t]``, whisper's ``['enc']`` / ``['dec']``: the state's
``jax_paths``), the same under
``.opt.mu`` and ``.opt.nu``, then ``.opt.count`` and ``.step`` (int32), so
either package resumes the other's training checkpoint.  Restoring one
takes a template state (any device, ``meta`` too), as JAX's restore does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointCorrupt", "CheckpointManager", "engine_leaves", "to_arrays",
           "from_arrays", "train_to_arrays", "train_from_arrays"]


class CheckpointCorrupt(RuntimeError):
    """A step's bytes do not match its recorded integrity digest."""


_DIR_LOCKS: dict[str, threading.Lock] = {}
_DIR_LOCKS_GUARD = threading.Lock()
_TMP_COUNTER = itertools.count()


def _dir_lock(directory: str) -> threading.Lock:
    key = os.path.realpath(directory)
    with _DIR_LOCKS_GUARD:
        return _DIR_LOCKS.setdefault(key, threading.Lock())


# (field, stored dtype, the port's dtype); the states (first) keep their own
_PT = (("energy", np.float32, torch.float32),
       ("rung", np.int32, torch.int32), ("key", np.uint32, torch.int64),
       ("phase", np.int32, torch.int64), ("t", np.int32, torch.int64))
_STATS = (("n_records", np.int32, torch.int32), ("weight_sum", np.float32, torch.float32),
          ("mean", np.float32, torch.float32), ("m2", np.float32, torch.float32),
          ("swap_attempts", np.float32, torch.float32),
          ("swap_accepts", np.float32, torch.float32),
          ("direction", np.int8, torch.int8), ("round_trips", np.int32, torch.int32),
          ("up_visits", np.float32, torch.float32),
          ("labeled_visits", np.float32, torch.float32))


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def states_layout(states):
    """A state's leaf dtypes as numpy dtypes: one for a tensor, ``{key:
    dtype}`` for a dict of tensors (the form `engine_leaves` takes)."""
    def np_dtype(x):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    if isinstance(states, dict):
        return {k: np_dtype(v) for k, v in states.items()}
    return np_dtype(states)


def _arrays_layout(arrays):
    """`states_layout` of the state stored in checkpoint ``arrays``."""
    if ".pt.states" in arrays:
        return np.asarray(arrays[".pt.states"]).dtype
    prefix = ".pt.states['"
    return {n[len(prefix):-2]: np.asarray(a).dtype for n, a in arrays.items()
            if n.startswith(prefix)}


def engine_leaves(series, states):
    """``(name, attribute path, stored numpy dtype, torch dtype)`` of every
    leaf of an ``EngineState`` whose moments track ``series`` and whose
    state has the leaves ``states`` (`states_layout`), in JAX's flatten
    order (dataclass fields in order, dict keys sorted)."""
    if isinstance(states, dict):
        out = [(f".pt.states[{k!r}]", ("pt", "states", k), states[k],
                _torch_dtype(states[k])) for k in sorted(states)]
    else:
        out = [(".pt.states", ("pt", "states"), states, _torch_dtype(states))]
    out += [(f".pt.{f}", ("pt", f), nd, td) for f, nd, td in _PT]
    for f, nd, td in _STATS:
        if f in ("mean", "m2"):
            out += [(f".stats.{f}[{k!r}]", ("stats", f, k), nd, td) for k in sorted(series)]
        else:
            out.append((f".stats.{f}", ("stats", f), nd, td))
    out.append((".betas", ("betas",), np.float32, torch.float32))
    return out


def _get(tree, path):
    for p in path:
        tree = tree[p] if isinstance(tree, dict) else getattr(tree, p)
    return tree


def to_arrays(tree) -> dict[str, np.ndarray]:
    """Host numpy copies of every leaf under its checkpoint name and dtype."""
    return {name: _get(tree, path).detach().cpu().numpy().astype(nd)
            for name, path, nd, _ in engine_leaves(tree.stats.mean,
                                                   states_layout(tree.pt.states))}


def _series(arrays) -> list[str]:
    return sorted(n[len(".stats.mean['"):-2] for n in arrays
                  if n.startswith(".stats.mean['"))


def from_arrays(arrays: dict[str, np.ndarray], device, like=None):
    """The port's ``EngineState`` from checkpoint arrays, on ``device``.

    With a template ``like`` (any device, ``meta`` too) every leaf it has
    must be present with its shape, and extra leaves are ignored.
    """
    from repro_torch.core.pt import PTState
    from repro_torch.engine.driver import EngineState
    from repro_torch.engine.stats import OnlineStats

    if like is None:
        leaves = engine_leaves(_series(arrays), _arrays_layout(arrays))
    else:
        leaves = engine_leaves(like.stats.mean, states_layout(like.pt.states))
    values = {}
    for name, path, _, td in leaves:
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = np.asarray(arrays[name])
        if like is not None:
            want = tuple(_get(like, path).shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{name}: shape {arr.shape} != expected {want}")
        values[path] = torch.from_numpy(np.array(arr)).to(dtype=td, device=device)

    def build(cls, prefix):
        kw = {}
        for f in dataclasses.fields(cls):
            p = (*prefix, f.name)
            if p in values:
                kw[f.name] = values[p]
            else:  # a dict of series
                kw[f.name] = {k[-1]: v for k, v in values.items() if k[:-1] == p}
        return cls(**kw)

    return EngineState(pt=build(PTState, ("pt",)), stats=build(OnlineStats, ("stats",)),
                       betas=values[("betas",)])


def _is_train_state(tree) -> bool:
    return hasattr(tree, "opt") and hasattr(tree, "params")


def train_to_arrays(state) -> dict[str, np.ndarray]:
    """Host numpy copies of a training state's leaves under JAX's names:
    f32 trees with the layers stacked, the count and the step int32."""
    from repro_torch.models import jax_tree

    out = {}
    for prefix, tree in ((".params", state.params), (".opt.mu", state.opt.mu),
                         (".opt.nu", state.opt.nu)):
        stacks: dict[str, dict[int, np.ndarray]] = {}
        for name, (key, layer) in jax_tree.tree_names(prefix, tree, state.jax_paths).items():
            a = tree[name].detach().cpu().numpy().astype(np.float32)
            if layer is None:
                out[key] = a
            else:
                stacks.setdefault(key, {})[layer] = a
        for key, per in stacks.items():
            out[key] = np.stack([per[i] for i in range(len(per))])
    out[".opt.count"] = state.opt.count.detach().cpu().numpy().astype(np.int32)
    out[".step"] = state.step.detach().cpu().numpy().astype(np.int32)
    return dict(sorted(out.items()))


def train_from_arrays(arrays: dict[str, np.ndarray], device, like):
    """A training state on ``device`` from checkpoint arrays, leaf names and
    shapes from the template ``like`` (any device)."""
    from repro_torch.models import jax_tree
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    def tree(prefix, template):
        out = {}
        for name, (key, layer) in jax_tree.tree_names(prefix, template, like.jax_paths).items():
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            a = np.asarray(arrays[key])
            if layer is not None:
                a = a[layer]
            want = tuple(template[name].shape)
            if tuple(a.shape) != want:
                raise ValueError(f"{key}: shape {a.shape} != expected {want}")
            out[name] = torch.from_numpy(np.array(a, np.float32)).to(device)
        return out

    def scalar(key):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        return torch.as_tensor(np.asarray(arrays[key], np.int32).reshape(()), device=device)

    return TrainState(params=tree(".params", like.params),
                      opt=AdamWState(mu=tree(".opt.mu", like.opt.mu),
                                     nu=tree(".opt.nu", like.opt.nu),
                                     count=scalar(".opt.count")),
                      step=scalar(".step"), jax_paths=like.jax_paths)


class CheckpointManager:
    """Checkpoints of one run (or one serve bucket) in ``directory``.

    ``faults`` (a `repro_torch.resilience.FaultPlan`, None in production)
    arms the write seams ``checkpoint.write.torn``, ``.corrupt``,
    ``.crash_before_rename`` and ``.crash_after_rename``, each one ``is
    None`` test when off; `child` managers share it.
    """

    def __init__(self, directory: str, keep: int = 3, process_index: int = 0,
                 faults=None):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        self._faults = faults
        os.makedirs(directory, exist_ok=True)
        self._writer: threading.Thread | None = None
        # generations skipped by the last `restore_latest` (0: the newest was intact)
        self.last_restore_fallback = 0

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def _staging_dir(self, step: int) -> str:
        token = f"{os.getpid()}-{next(_TMP_COUNTER)}"
        return f"{self._step_dir(step)}.{token}.tmp"

    def child(self, name: str) -> "CheckpointManager":
        """A manager rooted in the subdirectory ``name`` (same retention)."""
        return CheckpointManager(os.path.join(self.dir, name), keep=self.keep,
                                 process_index=self.proc, faults=self._faults)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    # -- integrity -----------------------------------------------------------
    def _arrays_name(self) -> str:
        return f"arrays_p{self.proc}.npz"

    @staticmethod
    def _sha256(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()

    def step_readable(self, step: int) -> bool:
        """The meta parses and every file it records has its recorded size
        (steps without a manifest: the arrays file is non-empty).  Digests
        are checked on `restore`, not here."""
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        integrity = meta.get("integrity")
        if integrity is None:
            try:
                return os.path.getsize(os.path.join(d, self._arrays_name())) > 0
            except OSError:
                return False
        for fname, rec in integrity.items():
            try:
                if os.path.getsize(os.path.join(d, fname)) != rec["bytes"]:
                    return False
            except (OSError, KeyError, TypeError):
                return False
        return True

    def readable_steps(self) -> list[int]:
        return [s for s in self.steps() if self.step_readable(s)]

    def _verify(self, step: int) -> None:
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        for fname, rec in meta.get("integrity", {}).items():
            path = os.path.join(d, fname)
            size = os.path.getsize(path)
            if size != rec["bytes"]:
                raise CheckpointCorrupt(
                    f"{path}: {size} bytes on disk, manifest says {rec['bytes']} (torn write)"
                )
            digest = self._sha256(path)
            if digest != rec["sha256"]:
                raise CheckpointCorrupt(
                    f"{path}: content digest {digest[:12]}… != manifest "
                    f"{rec['sha256'][:12]}… (corrupt bytes)"
                )

    # -- run description -------------------------------------------------------
    def save_spec(self, spec: Any):
        """Write the run description (a JSON string or dict) atomically."""
        text = spec if isinstance(spec, str) else json.dumps(spec, indent=2)
        json.loads(text)  # fail fast on non-JSON input
        token = f"{os.getpid()}-{next(_TMP_COUNTER)}"
        tmp = os.path.join(self.dir, f"spec.json.{token}.tmp")
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, os.path.join(self.dir, "spec.json"))

    def load_spec(self) -> dict | None:
        path = os.path.join(self.dir, "spec.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: dict | None = None, blocking: bool = True):
        """Checkpoint ``tree`` at ``step``.  The device-to-host copy happens
        here, before any writer thread starts; the file I/O may run on one."""
        arrays = train_to_arrays(tree) if _is_train_state(tree) else to_arrays(tree)
        meta = dict(meta or {}, step=step, time=time.time())
        self.wait()  # at most one outstanding write

        def write():
            tmp = self._staging_dir(step)
            os.makedirs(tmp, exist_ok=True)
            arrays_name = self._arrays_name()
            arrays_path = os.path.join(tmp, arrays_name)
            np.savez(arrays_path, **arrays)
            # the digest of the staged bytes before any injected damage
            # below: a torn or flipped file no longer matches it on restore
            meta["integrity"] = {arrays_name: {
                "sha256": self._sha256(arrays_path),
                "bytes": os.path.getsize(arrays_path),
            }}
            if self._faults is not None:
                if self._faults.check("checkpoint.write.torn") is not None:
                    size = os.path.getsize(arrays_path)
                    with open(arrays_path, "r+b") as f:
                        f.truncate(size // 2)
                if self._faults.check("checkpoint.write.corrupt") is not None:
                    size = os.path.getsize(arrays_path)
                    with open(arrays_path, "r+b") as f:
                        f.seek(size // 2)
                        byte = f.read(1)
                        f.seek(size // 2)
                        f.write(bytes([byte[0] ^ 0xFF]))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if self._faults is not None and self._faults.check(
                "checkpoint.write.crash_before_rename"
            ) is not None:
                from repro_torch.resilience.faults import InjectedCrash

                raise InjectedCrash(f"killed before renaming {tmp} (staging dir left behind)")
            final = self._step_dir(step)
            with _dir_lock(self.dir):
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            if self._faults is not None and self._faults.check(
                "checkpoint.write.crash_after_rename"
            ) is not None:
                from repro_torch.resilience.faults import InjectedCrash

                raise InjectedCrash(f"killed after renaming {final} (step dir is whole)")

        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _gc(self):
        if not self.keep:
            return
        steps = self.steps()
        # only readable steps count toward ``keep``: a torn newest step never
        # pushes the last intact one out
        readable = [s for s in steps if self.step_readable(s)]
        protect = set(readable[-self.keep:] if readable else steps[-self.keep:])
        for s in steps:
            if s not in protect:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, tree_like: Any = None, verify: bool = True, device=None):
        """``(state, meta)`` of ``step`` on ``device`` (default: the
        template's device, else the CPU), digests checked first.  A
        training state needs its template ``tree_like``."""
        d = self._step_dir(step)
        if verify:
            self._verify(step)
        with np.load(os.path.join(d, self._arrays_name())) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if _is_train_state(tree_like):
            dev = tree_like.step.device if device is None else torch.device(device)
            return train_from_arrays(arrays, "cpu" if dev.type == "meta" else dev,
                                     tree_like), meta
        if device is None:
            device = "cpu" if tree_like is None else tree_like.betas.device
        return from_arrays(arrays, device, like=tree_like), meta

    def restore_latest(self, tree_like: Any = None, device=None):
        """Newest-first restore past unreadable steps; None when there is no
        step, and a RuntimeError when no step could be restored."""
        self.wait()
        errors = []
        self.last_restore_fallback = 0
        for step in reversed(self.steps()):
            try:
                out = self.restore(step, tree_like, device=device)
                self.last_restore_fallback = len(errors)
                return out
            except Exception as e:  # corrupt or incomplete: try an older one
                errors.append((step, repr(e)))
        self.last_restore_fallback = len(errors)
        if errors:
            raise RuntimeError(f"no restorable checkpoint; tried {errors}")
        return None
