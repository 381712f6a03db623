"""PyTorch + CUDA port of the RandomizedCCA reproduction.

Mirrors the subpackages of the JAX package ``repro`` (``core``, ``exec``,
``kernels``, ``data``, ``configs``, ``store``, ``ckpt``, ``cluster``,
``serve``, ``launch``), so each module here has one reference module
there.  The port imports neither ``jax`` nor
``repro``; only the tests hold the two packages against each other.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the
data-pass products run in the hand-written CUDA kernels of
:mod:`repro_torch.kernels`.  ``device="cpu"`` runs the same code with
each kernel's plain PyTorch version — that is how the CPU tests drive it.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
