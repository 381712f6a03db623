"""Feed-forward blocks: the dense gated MLP (SwiGLU/GeGLU) or plain MLP.

Port of the dense part of ``repro/models/ffn.py``.  The MoE block waits
for the MoE family (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Mapping

import torch

from .common import act_fn, dense_init
from .config import FFNConfig


def init_mlp(gen: torch.Generator, cfg: FFNConfig, d_model: int, dtype) -> dict:
    p = {
        "w_up": dense_init(gen, d_model, cfg.d_ff, dtype),
        "w_down": dense_init(gen, cfg.d_ff, d_model, dtype),
    }
    if cfg.gated:
        p["w_gate"] = dense_init(gen, d_model, cfg.d_ff, dtype)
    return p


def mlp_forward(p: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: FFNConfig) -> torch.Tensor:
    h = x @ p["w_up"]
    if cfg.gated:
        h = act_fn(cfg.act)(x @ p["w_gate"]) * h
    else:
        h = act_fn(cfg.act)(h)
    return h @ p["w_down"]
