"""rslmtoasa — a real-space LMTO-ASA electronic-structure framework in JAX.

A from-scratch JAX/XLA implementation of the capabilities of the
RS-LMTO-ASA reference code (Haydock/block-Lanczos/Chebyshev recursion over
block-sparse real-space tight-binding Hamiltonians, self-consistent
charge/spin densities, LDOS, exchange couplings, Kubo-Bastin conductivity,
atomistic spin dynamics):

* geometry / structure-constant setup on host (NumPy, one-time),
* all recursion/Green-function hot loops as batched complex128 JAX
  computations (``vmap`` over chains, ``lax.scan`` over recursion depth)
  on the CPU or a GPU,
* multi-device scaling via ``jax.sharding`` meshes (``psum`` reductions
  over chain shards), mirroring the reference's MPI allreduce semantics.
"""

__version__ = "0.1.0"

import os

# The physics requires f64 for parity with the Fortran reference
# (tests demand 1e-6 agreement; see SURVEY.md §4).
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax

jax.config.update("jax_enable_x64", True)

from .config import JobConfig  # noqa: E402

__all__ = ["JobConfig", "__version__"]
