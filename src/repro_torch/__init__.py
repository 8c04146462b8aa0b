"""PyTorch/CUDA port of the `repro` parallel-tempering sampler.

The package mirrors `repro`'s subpackage layout (``kernels``, ``core``,
``exchange``, ``engine``, ``api``) so every module has an obvious twin, and
is held bit-exact against it from the same seed on the ported path: 2-D
Ising checkerboard sweeps plus temp-mode replica exchange through the
interval-fused (``use_fused``) and whole-round (``use_fused_round``)
kernels.  Those kernels are hand-written CUDA for Hopper
(`repro_torch.kernels.csrc`); every one has a plain PyTorch version beside
it, which is what runs for tensors on the CPU.

Importing the package touches no CUDA state and builds nothing: the kernels
are compiled with ``nvcc`` on first launch (`repro_torch.kernels.build`).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
