"""Model zoo (port of ``repro.models``): the dense attention family as
PyTorch modules.  The configuration dataclasses cover every architecture;
:func:`build_model` builds the ``attn`` family and raises for the others
(ROADMAP Queue 1 item 6)."""

from .config import (
    AttnConfig,
    FFNConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    XLSTMConfig,
    repeat_pattern,
)
from .transformer import LMModel


def build_model(cfg: ModelConfig, *, device="cuda", seed: int = 0) -> LMModel:
    """Instantiate the model of a config on ``device``, its weights drawn
    from ``seed``; raises ``NotImplementedError`` for a family the port
    does not build yet (:class:`LMModel`)."""
    return LMModel(cfg, device=device, seed=seed)


__all__ = [
    "AttnConfig",
    "FFNConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "repeat_pattern",
    "LMModel",
    "build_model",
]
