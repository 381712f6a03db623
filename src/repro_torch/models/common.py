"""Shared building blocks: initializers, norms, rotary embeddings.

Port of ``repro/models/common.py`` for the dense attention family.
Weights keep the reference's (in, out) layout, so a layer computes
``x @ w`` as it does there.  The sharding helpers (``shard`` and the
policy) are left out: the port holds a model on one device, where the
reference's ``shard`` is a no-op too.  ``layernorm``, ``apply_mrope`` and
``sinusoidal_positions`` wait for whisper and qwen2-vl (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

f32 = torch.float32


# --------------------------------------------------------------------------
# init helpers: drawn in f32 from a torch.Generator, one cast
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=f32, device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=f32, device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by (1 + γ): γ is stored as (gain − 1)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)  # stored as (gamma - 1), gemma-style


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=f32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)  # θ taken as an f32 scalar, as jnp does


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: broadcastable to (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(f32) * freqs  # (..., seq, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default form


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]
