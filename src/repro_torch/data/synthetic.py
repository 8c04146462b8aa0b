"""Deterministic synthetic token pipeline (twin of `repro.data.synthetic`).

Plain numpy, kept as the port's own copy: `SyntheticLM.batch(step)` is a
pure function of (seed, step, host_index, host_count) and yields the same
arrays as the JAX package's for every one of them, so

* every host generates exactly its own shard (no data redistribution),
* restart-after-failure is exact: the checkpoint stores only `step`,
* elastic re-sharding just changes the (host_index, host_count) split.

The stream is a unigram-with-bigram-structure language: token t+1 is a noisy
function of token t, so training losses actually decrease.  Batches are
numpy ``int32`` arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = self.global_batch // self.host_count

    def _rng(self, step: int) -> np.random.Generator:
        # independent, reproducible stream per (seed, step, host)
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )

    def batch(self, step: int) -> dict:
        rng = self._rng(step)
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # structured stream: x_{t+1} = (a * x_t + c + noise) mod V
        a = 31
        x = np.empty((b, s + 1), np.int32)
        x[:, 0] = rng.integers(0, v, size=b)
        noise = (rng.random((b, s)) < 0.1) * rng.integers(1, v, size=(b, s))
        for t in range(s):
            x[:, t + 1] = (a * x[:, t] + 7 + noise[:, t]) % v
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield step, self.batch(step)
            step += 1
