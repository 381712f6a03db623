"""Core of the paper: RandomizedCCA and its exact oracle (port of
``repro.core``)."""

from .exact import CCASolution, cca_objective, exact_cca, feasibility_errors
from .rcca import (
    RCCAConfig,
    RCCAResult,
    draw_omega,
    randomized_cca,
    randomized_cca_iterator,
    randomized_cca_streaming,
)

__all__ = [
    "CCASolution",
    "cca_objective",
    "draw_omega",
    "exact_cca",
    "feasibility_errors",
    "RCCAConfig",
    "RCCAResult",
    "randomized_cca",
    "randomized_cca_iterator",
    "randomized_cca_streaming",
]
