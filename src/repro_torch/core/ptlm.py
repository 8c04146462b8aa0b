"""Parallel tempering over LM token sequences (twin of `repro.core.ptlm`).

A replica holds a token sequence (R, S) int32, its energy is the sequence's
NLL past the prompt under the model, and the ladder flattens the sequence
distribution as it flattens a Boltzmann one.  One MH move a replica and
step: pick a position past the prompt, propose a token from the model's
own conditional there, accept with

    log A = -beta (E' - E) + (q(x_old) - q(x_new))

(q is the conditional both proposals are drawn from; it depends only on the
unchanged prefix).  All replicas advance in one batched forward.

Every draw is the JAX package's, word for word (`repro_torch.core.keys`):

* the initial tokens: ``randint(k_init, (R, S), 0, vocab)`` from the
  unsplit init key (JAX's batched ``init_state_batched(key, R)``;
  `init_state_from_key`, which `repro_torch.core.systems.batched_init`
  prefers to the per-replica keys it hands the zoo systems);
* a step's key is replica 0's per-sweep key ``fold_in(fold_in(key, 2t),
  0)``, which JAX's step takes as ``keys[0]``; on a mesh a replica shard's
  first slot's, ``fold_in(fold_in(key, 2t), offset)`` (JAX's sharded
  interval hands the system the rank's keys, and the step reads the
  first), so a mesh run is another chain than the unsharded one, as in
  JAX; ``split(key, 3)`` gives
  ``randint(k_pos, (R,), prompt_len, S)``, ``categorical(k_tok, logits)``
  on the f32 logits and ``uniform(k_acc, (R,), minval=1e-20)``.

A step runs three forwards, as JAX's does: the hidden states of the
current tokens (their conditionals at the chosen positions), then the
energies of the old and the proposed sequences.  On the card each forward
of an rwkv model launches kernel #7 once a layer; a dense model runs
`torch` ops and cuBLAS.  The log-softmaxes are ``x - max - log(sum(exp(x
- max)))`` in f32, as ``jax.nn.log_softmax``.  Everything runs under
``no_grad``.

`LMSystem.bind(model)` takes the port's `repro_torch.models.transformer.
LM` (JAX's ``bind(params)`` takes its parameter tree) and returns the
batched system that `repro_torch.core.pt` and `repro_torch.engine.Engine`
drive on their per-sweep path, on one device or on the PT mesh
(`EngineConfig.mesh`), where each rank steps its block of replicas.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keys
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

__all__ = ["LMSystem", "BoundLMSystem", "log_softmax"]

def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


@dataclasses.dataclass(frozen=True)
class LMSystem:
    """PT-sampleable description of a decoder-only LM's sequences."""

    cfg: ModelConfig
    seq_len: int
    prompt_len: int = 1

    def bind(self, model) -> "BoundLMSystem":
        return BoundLMSystem(self, model)


class BoundLMSystem:
    """The batched System of the port (see `repro_torch.core.systems.System`)
    closed over a model."""

    def __init__(self, spec: LMSystem, model):
        if not 1 <= spec.prompt_len < spec.seq_len:
            raise ValueError(f"need 1 <= prompt_len < seq_len, got {spec.prompt_len}, "
                             f"{spec.seq_len}")
        self.spec = spec
        self.model = model
        self.cfg = spec.cfg

    # -- scoring -----------------------------------------------------------------------
    def _hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer.backbone(self.model, self.cfg, tokens)

    def _unembed(self) -> torch.Tensor:
        return transformer.unembed_matrix(self.model, self.cfg).to(self.cfg.compute_dtype)

    def _token_logprobs(self, tokens: torch.Tensor) -> torch.Tensor:
        """(R, S-1) f32 log p(x_t | x_<t) for t = 1..S-1."""
        cfg = self.cfg
        hidden = self._hidden(tokens)[:, :-1].to(cfg.compute_dtype)
        r, s1, d = hidden.shape
        logits = transformer.mm_f32(hidden.reshape(r * s1, d), self._unembed())
        logits = logits.reshape(r, s1, -1)
        logp = log_softmax(logits)
        return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]

    @torch.no_grad()
    def batched_energy(self, tokens: torch.Tensor) -> torch.Tensor:
        """(R,) f32 ``E(x) = -log p(x_{prompt:} | prompt)``."""
        lp = self._token_logprobs(tokens)
        mask = torch.arange(1, tokens.shape[1], device=tokens.device) >= self.spec.prompt_len
        return -(lp * mask).sum(dim=-1)

    # -- the System protocol (batched) ----------------------------------------------
    def init_state_from_key(self, key: torch.Tensor, n_replicas: int) -> torch.Tensor:
        """(R, S) int32 uniform tokens from the unsplit key, as JAX draws them."""
        return keys.randint(key, (n_replicas, self.spec.seq_len), 0, self.cfg.vocab)

    @torch.no_grad()
    def batched_mcmc_step(self, key: torch.Tensor, t, tokens: torch.Tensor,
                          betas: torch.Tensor, replica_offset: int = 0):
        """One coordinate MH move per replica at sweep ``t``; returns
        ``(tokens', delta_e (R,) f32, accepted (R,) int32)``.  A replica
        shard passes its first global slot as ``replica_offset``: its words
        come from that slot's key, as JAX's sharded step takes them."""
        cfg, spec = self.cfg, self.spec
        r, s = tokens.shape
        step_key = keys.fold_in(keys.fold_in(key, 2 * t), replica_offset)  # JAX's keys[0]
        k_pos, k_tok, k_acc = keys.split(step_key, 3)
        pos = keys.randint(k_pos, (r,), spec.prompt_len, s).long()
        rows = torch.arange(r, device=tokens.device)

        # the conditionals at pos depend only on the prefix: the same for the
        # old and the proposed sequence
        hidden = self._hidden(tokens)
        h_at = hidden[rows, pos - 1].to(cfg.compute_dtype)
        logits = transformer.mm_f32(h_at, self._unembed())
        q = log_softmax(logits)  # (R, V)
        new_tok = keys.categorical(k_tok, logits)
        old_tok = tokens[rows, pos].long()
        proposed = tokens.clone()
        proposed[rows, pos] = new_tok.to(tokens.dtype)

        e_old = self.batched_energy(tokens)
        e_new = self.batched_energy(proposed)
        q_new = q[rows, new_tok]
        q_old = q[rows, old_tok]
        log_a = -betas * (e_new - e_old) + (q_old - q_new)
        accept = torch.log(keys.uniform(k_acc, (r,), minval=1e-20)) < log_a
        tokens = torch.where(accept[:, None], proposed, tokens)
        de = torch.where(accept, e_new - e_old, 0.0)
        return tokens, de, accept.to(torch.int32)
