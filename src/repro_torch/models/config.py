"""Declarative model configuration covering all assigned architectures.

Port of ``repro/models/config.py``, the same dataclasses and numbers.
One ``ModelConfig`` describes any member of the zoo: dense GQA LMs,
sliding-window hybrids (gemma3), MLA/MoE (deepseek-v2), giant MoE
(kimi-k2), SSM (xlstm), Mamba2+shared-attention hybrids (zamba2),
encoder–decoder audio (whisper) and M-RoPE VLMs (qwen2-vl).  The port
builds the dense attention family only (:func:`repro_torch.models.build_model`).

``layer_pattern`` drives structure: the port loops over the layers in
Python, each layer taking its kind (full or windowed attention) from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128  # per-head non-rotary q/k dims
    rope_dim: int = 64  # shared rotary key dims
    v_dim: int = 128  # per-head value dims


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10_000.0
    local_rope_theta: Optional[float] = None  # gemma3: 10k local / 1M global
    window: Optional[int] = None  # sliding-window size for "local" layers
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    mrope: bool = False  # qwen2-vl M-RoPE (3-section rotary)
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class FFNConfig:
    d_ff: int
    act: str = "silu"  # silu | gelu
    gated: bool = True  # SwiGLU/GeGLU vs plain MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # deepseek: 2 shared experts
    d_ff_shared: int = 0
    router_scale: float = 1.0
    aux_loss_coef: float = 0.001
    n_dense_layers: int = 1  # leading dense-FFN layers
    capacity_factor: float = 1.25  # GShard capacity (≥ E/K ⇒ lossless)
    # GShard grouped dispatch: tokens are routed within G groups whose
    # leading dim shards over the data axes, so dispatch buffers stay
    # O(T·K·D/G) per device.  Set to the data-parallel degree.
    dispatch_groups: int = 32


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: alternating mLSTM (matrix memory) / sLSTM blocks."""

    n_heads: int = 4
    proj_factor_m: float = 2.0  # mLSTM up-projection
    proj_factor_s: float = 1.3333  # sLSTM ffn factor
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    attn: Optional[AttnConfig] = None
    ffn: Optional[FFNConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # layer_pattern entries: "attn" (full) | "local" (windowed attn) |
    # "mamba" | "shared_attn" | "mlstm" | "slstm".  Length == n_layers.
    layer_pattern: Optional[Tuple[str, ...]] = None
    kind: str = "decoder"  # decoder | encdec
    n_enc_layers: int = 0  # whisper encoder depth
    enc_width: int = 0  # encoder d_model (== d_model here)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    max_seq: int = 131_072
    dtype: str = "bfloat16"
    # frontend stubs ([audio]/[vlm]): inputs are precomputed embeddings
    frontend: Optional[str] = None  # None | "audio_frames" | "vision_patches"
    final_logit_softcap: Optional[float] = None

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.n_layers, self.name
            return self.layer_pattern
        return ("attn",) * self.n_layers

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in sequence length (SSM/xLSTM)."""
        pat = set(self.pattern())
        return pat <= {"mamba", "mlstm", "slstm", "shared_attn"} and (
            "mamba" in pat or "mlstm" in pat or "slstm" in pat
        )

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (DESIGN.md §long_500k)."""
        pat = self.pattern()
        n_global = sum(1 for p in pat if p in ("attn", "shared_attn"))
        return self.is_recurrent or ("local" in pat and n_global <= len(pat) // 4)


def repeat_pattern(unit: Tuple[str, ...], n_layers: int) -> Tuple[str, ...]:
    """Tile ``unit`` cyclically to exactly n_layers entries."""
    reps = (n_layers + len(unit) - 1) // len(unit)
    return (unit * reps)[:n_layers]
