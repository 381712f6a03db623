"""The decoder-only LM of the dense attention family: train forward,
prefill and decode.

Port of ``repro/models/transformer.py``'s ``LMModel`` for the ``attn``
family (full attention, and gemma3's local/global mix).  The reference
stacks each parameter over the layers and scans; the port holds an
``nn.ModuleList`` of layers and loops over them in Python, each layer
taking its mask (local or global) and its rope θ from the pattern.
Parameters keep the reference's names and (in, out) layout, so its
``init`` tree loads by unstacking (:mod:`repro_torch.models.convert`).

The other families (MoE/MLA, xLSTM, the zamba2 hybrid, whisper's
encoder-decoder) and qwen2-vl's M-RoPE and patch embeddings are not
ported yet: :class:`LMModel` raises for them (ROADMAP Queue 1 item 6).
So does the training path; parameters hold no gradients.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..dtypes import torch_dtype
from . import attention as attn
from . import ffn as ffn_mod
from .common import embed_init, init_rmsnorm, rmsnorm, softcap
from .config import ModelConfig

NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 6)"


def model_family(cfg: ModelConfig) -> str:
    """The reference's family of a config: ``attn``, ``moe``, ``xlstm``,
    ``zamba``, or ``encdec`` for an encoder-decoder."""
    if cfg.kind == "encdec":
        return "encdec"
    pat = set(cfg.pattern())
    if pat <= {"attn", "local"}:
        return "attn"
    if pat <= {"attn", "attn_moe"}:
        return "moe"
    if pat <= {"mlstm", "slstm"}:
        return "xlstm"
    if pat <= {"mamba", "shared_attn"}:
        return "zamba"
    raise ValueError(f"unsupported pattern {pat}")


class Block(nn.Module):
    """One layer: pre-norm attention, then a pre-norm MLP, each residual."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, dtype):
        super().__init__()
        d = cfg.d_model
        self.ln_attn = nn.Parameter(init_rmsnorm(d, dtype, gen.device))
        self.attn = nn.ParameterDict(attn.init_gqa(gen, cfg.attn, d, dtype))
        self.ln_ffn = nn.Parameter(init_rmsnorm(d, dtype, gen.device))
        self.ffn = nn.ParameterDict(ffn_mod.init_mlp(gen, cfg.ffn, d, dtype))

    def forward(self, x, cfg: ModelConfig, theta: float, mask,
                cache: Optional[attn.KVCache] = None) -> torch.Tensor:
        h = rmsnorm(x, self.ln_attn, cfg.norm_eps)
        out, _ = attn.gqa_forward(self.attn, h, cfg.attn, mask=mask, rope_theta=theta,
                                  cache=cache)
        x = x + out
        h = rmsnorm(x, self.ln_ffn, cfg.norm_eps)
        return x + ffn_mod.mlp_forward(self.ffn, h, cfg.ffn)


class LMModel(nn.Module):
    """Decoder-only language model of the attention family, its weights
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``
    (the same distribution as the reference's ``init``, not its bits)."""

    def __init__(self, cfg: ModelConfig, *, device=DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        fam = model_family(cfg)
        if fam != "attn":
            raise NotImplementedError(f"{cfg.name}: the {fam} family is {NOT_PORTED}")
        if cfg.attn.mrope or cfg.frontend is not None:
            raise NotImplementedError(f"{cfg.name}: M-RoPE and stub frontends are {NOT_PORTED}")
        self.cfg = cfg
        self.pattern = cfg.pattern()
        self.dtype = torch_dtype(cfg.dtype)
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        dt = self.dtype
        self.embed = nn.Parameter(embed_init(gen, cfg.vocab, cfg.d_model, dt))
        self.final_norm = nn.Parameter(init_rmsnorm(cfg.d_model, dt, self.device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(embed_init(gen, cfg.vocab, cfg.d_model, dt))
        self.layers = nn.ModuleList(Block(cfg, gen, dt) for _ in range(cfg.n_layers))
        self.requires_grad_(False)  # serving and harvesting only

    # ---------------- layers ----------------

    def _has_local(self) -> bool:
        return self.cfg.attn.window is not None and "local" in self.pattern

    def _layers(self, mask_g, mask_l, depth: Optional[int] = None):
        """(block, rope θ, mask) for each of the first ``depth`` layers:
        gemma3's local layers take the local θ and, with a window, the
        local mask; the others the global ones."""
        a = self.cfg.attn
        theta_l = a.local_rope_theta or a.rope_theta
        for lp, kind in zip(self.layers[:depth], self.pattern):
            if kind == "local":
                yield lp, theta_l, mask_g if mask_l is None else mask_l
            else:
                yield lp, a.rope_theta, mask_g

    # ---------------- forward ----------------

    def embed_tokens(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        x = nn.functional.embedding(tokens, self.embed)
        if self.cfg.embed_scale:  # √d in f32, then cast, as the reference
            scale = torch.tensor(self.cfg.d_model, dtype=torch.float32).sqrt()
            x = x * scale.to(x.dtype)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits (the reference's ``preferred_element_type``): bf16
        operands are widened, so each product is exact and sums in f32."""
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed if self.cfg.tie_embeddings else self.lm_head
        lg = x.float() @ head.float().T
        return softcap(lg, self.cfg.final_logit_softcap)

    def forward_hidden(self, batch: Dict[str, torch.Tensor], *,
                       depth: Optional[int] = None) -> torch.Tensor:
        """Pre-norm hidden states (B, S, D) after the first ``depth``
        layers (all by default)."""
        x = self.embed_tokens(batch["tokens"])
        cfg, S = self.cfg, x.shape[1]
        mask_g = attn.make_mask(S, S, causal=cfg.attn.causal, window=None, device=self.device)
        mask_l = (attn.make_mask(S, S, causal=cfg.attn.causal, window=cfg.attn.window,
                                 device=self.device) if self._has_local() else None)
        for lp, theta, mask in self._layers(mask_g, mask_l, depth):
            x = lp(x, cfg, theta, mask)
        return x

    def forward_train(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: {"tokens": (B, S)}.  Returns the f32 logits (B, S, V)."""
        return self.logits(self.forward_hidden(batch))

    # ---------------- serving: cache init / prefill / decode ----------------

    def init_cache(self, B: int, max_seq: int) -> attn.KVCache:
        """Zeros of (L, B, max_seq, Kv, hd) for K and V; position 0."""
        return attn.init_gqa_cache(self.cfg.attn, self.cfg.n_layers, B, max_seq, self.dtype,
                                   self.device)

    def decode_step(self, tokens, cache: attn.KVCache) -> Tuple[torch.Tensor, attn.KVCache]:
        """One serving step: tokens (B, S) with small S (1 for decode) at
        ``cache.pos``; writes their keys and values into ``cache`` in
        place and advances its position.  Returns (f32 logits (B, S, V),
        cache)."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        S, T, pos = x.shape[1], cache.k.shape[2], cache.pos
        kpos = torch.arange(T, device=self.device)[None, :]
        qpos = pos + torch.arange(S, device=self.device)[:, None]
        mask_g = (kpos <= qpos)[None, None]
        mask_l = (mask_g & (kpos > qpos - cfg.attn.window)[None, None]
                  if self._has_local() else None)
        for i, (lp, theta, mask) in enumerate(self._layers(mask_g, mask_l)):
            x = lp(x, cfg, theta, mask, cache.layer(i))
        cache.pos = pos + S
        return self.logits(x), cache

    def prefill(self, tokens, cache: attn.KVCache) -> Tuple[torch.Tensor, attn.KVCache]:
        """Fill the cache from a prompt: ``decode_step`` at S = prompt
        length, logits for all S positions."""
        return self.decode_step(tokens, cache)
