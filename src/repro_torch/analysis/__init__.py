"""Static analysis and sanitizers for the port (port of ``repro.analysis``).

Four checkers, one command line (``python -m repro_torch.analysis``):

- :mod:`~repro_torch.analysis.kernel_check`: every registered launch
  plan (``repro_torch.kernels.KERNEL_REGISTRY``) against RCCA101-108:
  grid coverage, operand tiles, threads, shared memory and blocks per
  SM, dtypes, the entry point's outputs and C function, Ω's seed;
- :mod:`~repro_torch.analysis.lint`: the AST architecture lint
  (RCCA001-007) over ``src/repro_torch``; ``# rcca: noqa[CODE]``
  suppresses with a justification;
- :mod:`~repro_torch.analysis.protocol`: the cluster protocol's recorder
  and trace checker (RCCA201-204) and the small-model interleaving
  explorer (RCCA205);
- :mod:`~repro_torch.analysis.sanitize`: the runtime determinism
  sanitizer (``RCCA_SANITIZE=1``, RCCA301).

Submodules import lazily: runtime modules (the accumulator's sanitizer
hook, the partial store's protocol events) import this package, which
must stay cheap and free of cycles.
"""

from .report import Violation, render_report

_SUBMODULES = ("kernel_check", "lint", "protocol", "report", "sanitize")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Violation", "render_report", *_SUBMODULES]
