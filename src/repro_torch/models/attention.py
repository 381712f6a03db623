"""Grouped-query attention: train, prefill and decode paths.

Port of the GQA part of ``repro/models/attention.py``.  Attention is the
reference's default path, ``_sdpa``, written as plain tensor operations:
the scores in f32 (the reference's ``preferred_element_type``), the
logit soft-cap, the boolean mask, a softmax in f32, then the product
with V in V's dtype.  One code path serves the CPU and the card.

Left for later slices (ROADMAP Queue 1 item 6): the flash scan and its
custom VJP (the training path), MLA (the MoE family), cross-attention
and M-RoPE (whisper, qwen2-vl).

The KV cache is a :class:`KVCache`: K and V tensors of shape (B, T, Kv,
hd), or (L, B, T, Kv, hd) for a whole model, written in place, and the
position of the next token as a Python int.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from .common import apply_rope, dense_init, init_rmsnorm, rmsnorm, softcap
from .config import AttnConfig

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """K and V of the tokens before ``pos``: (B, T, Kv, hd) for one layer,
    (L, B, T, Kv, hd) stacked over a model's layers."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int = 0

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache: views, so writes land in it."""
        return KVCache(self.k[i], self.v[i], self.pos)


def init_gqa(gen: torch.Generator, cfg: AttnConfig, d_model: int, dtype) -> dict:
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {
        "wq": dense_init(gen, d_model, H * hd, dtype),
        "wk": dense_init(gen, d_model, Kv * hd, dtype),
        "wv": dense_init(gen, d_model, Kv * hd, dtype),
        "wo": dense_init(gen, H * hd, d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, gen.device)
        p["k_norm"] = init_rmsnorm(hd, dtype, gen.device)
    return p


def _sdpa(q, k, v, mask, softcap_val=None):
    """q: (B,S,H,hd), k/v: (B,T,Kv,hd) — grouped attention.

    mask: (B,1,S,T) or (1,1,S,T) boolean (True = keep).
    """
    B, S, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    q = q.reshape(B, S, Kv, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    scores = softcap(scores, softcap_val)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H * hd)


def make_mask(S: int, T: int, *, causal: bool, window: Optional[int],
              device=None) -> torch.Tensor:
    """(1, 1, S, T) boolean mask of queries at positions 0..S-1."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


def gqa_forward(
    p: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    cfg: AttnConfig,
    *,
    mask: torch.Tensor,  # (1,1,S,T): the layer's local or global mask
    rope_theta: float,  # the layer's: gemma3's local layers take their own
    cache: Optional[KVCache] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (output, updated cache).

    - train/prefill without a cache: ``cache=None``, T = S;
    - with a cache: the S new keys and values are written into it in
      place at ``cache.pos`` (prefill is S = prompt length, decode S = 1),
      then the queries attend over the whole cache (T = its length); the
      returned cache has ``pos + S``.
    """
    B, S, _ = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim

    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Kv, hd)
    v = (x @ p["wv"]).reshape(B, S, Kv, hd)

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])

    pos = 0 if cache is None else cache.pos
    # rope over (B, S, heads, hd): the positions broadcast over the heads
    positions = pos + torch.arange(S, device=x.device)[None, :, None]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    new_cache = None
    if cache is not None:
        T = cache.k.shape[1]
        if pos + S > T:
            raise ValueError(f"KV cache of {T} positions cannot take {S} more at {pos}")
        cache.k[:, pos:pos + S] = k.to(cache.k.dtype)
        cache.v[:, pos:pos + S] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, pos + S)
        k, v = cache.k, cache.v

    out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    return out @ p["wo"], new_cache


def init_gqa_cache(cfg: AttnConfig, n_layers: int, B: int, max_seq: int, dtype,
                   device) -> KVCache:
    """Zeros of (n_layers, B, max_seq, Kv, hd): the reference's per-layer
    caches, stacked as its ``vmap`` stacks them."""
    shape = (n_layers, B, max_seq, cfg.n_kv, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)
