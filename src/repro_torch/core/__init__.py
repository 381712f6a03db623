"""Core of the paper: RandomizedCCA, its exact oracle and the Horst
baseline (port of ``repro.core``)."""

from .exact import CCASolution, cca_objective, exact_cca, feasibility_errors
from .horst import HorstConfig, HorstResult, horst_cca
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
    "HorstConfig",
    "HorstResult",
    "horst_cca",
    "RCCAConfig",
    "RCCAResult",
    "randomized_cca",
    "randomized_cca_iterator",
    "randomized_cca_streaming",
]
