"""PyTorch/CUDA port of the `repro` parallel-tempering sampler.

The package mirrors `repro`'s subpackage layout (``kernels``, ``core``,
``exchange``, ``engine``, ``api``, ``validate``) so every module has an
obvious twin, and is held bit-exact against it from the same seed on the
ported path: 2-D Ising and q-state Potts checkerboard sweeps plus temp-mode
replica exchange on the per-sweep, interval-fused (``use_fused``) and
whole-round (``use_fused_round``) paths, Ising multispin coding
(``pack_bits``), and the ensemble axis (``n_chains``); the rest of the
system zoo (the EA spin glass, the Gaussian mixture, the HP lattice protein,
Ising ``single_flip``) on the per-sweep path, the serial chains of HP and
``single_flip`` in one kernel; `validate` holds the chains against exact
answers.  Those kernels are hand-written CUDA for Hopper
(`repro_torch.kernels.csrc`); every one has a plain PyTorch version beside
it, which is what runs for tensors on the CPU.

Importing the package touches no CUDA state and builds nothing: the kernels
are compiled with ``nvcc`` on first launch (`repro_torch.kernels.build`).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
