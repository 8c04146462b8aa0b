"""Statistical validation of the port (twin of `repro.validate`).

* `repro_torch.validate.exact`: exact ⟨E⟩ and the order parameter of every
  zoo entry (enumeration for Ising, Potts, EA and the HP chain's
  self-avoiding walks; quadrature for the Gaussian mixture) and the HP
  move-graph check;
* `repro_torch.validate.mcse`: batch-means MCSE, ESS and a Geweke drift
  score over the engine's Welford accumulators;
* `repro_torch.validate.conformance`: drives the port's `Session` (adaptive
  ladder on, ensemble axis on, on the card unless ``device="cpu"``) over a
  `repro_torch.core.systems.REGISTRY` entry and compares every observable
  with its exact reference within MCSE-derived tolerances.
"""
from repro_torch.validate.conformance import ConformanceReport, assert_conforms, run_conformance
from repro_torch.validate.mcse import batch_mean_stats, effective_sample_size, geweke_z

__all__ = [
    "ConformanceReport",
    "assert_conforms",
    "batch_mean_stats",
    "effective_sample_size",
    "geweke_z",
    "run_conformance",
]
