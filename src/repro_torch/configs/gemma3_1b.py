"""gemma3-1b: 26L dense, 5:1 local:global sliding-window attention.

[hf:google/gemma-3-1b-pt; unverified]  GQA kv=1, head_dim=256, GeGLU,
qk-norm, dual rope theta (10k local / 1M global), 128k context.

Port of ``repro/configs/gemma3_1b.py``, the same numbers.
"""

from ..models.config import AttnConfig, FFNConfig, ModelConfig, repeat_pattern


def _pattern(n):
    return repeat_pattern(("local", "local", "local", "local", "local", "attn"), n)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        d_model=1152,
        n_layers=26,
        vocab=262_144,
        attn=AttnConfig(
            n_heads=4, n_kv=1, head_dim=256,
            rope_theta=1_000_000.0, local_rope_theta=10_000.0,
            window=512, qk_norm=True,
        ),
        ffn=FFNConfig(d_ff=6912, act="gelu", gated=True),
        layer_pattern=_pattern(26),
        tie_embeddings=True,
        embed_scale=True,
        max_seq=131_072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke",
        d_model=64,
        n_layers=6,
        vocab=512,
        attn=AttnConfig(
            n_heads=2, n_kv=1, head_dim=32,
            rope_theta=1_000_000.0, local_rope_theta=10_000.0,
            window=16, qk_norm=True,
        ),
        ffn=FFNConfig(d_ff=128, act="gelu", gated=True),
        layer_pattern=_pattern(6),
        tie_embeddings=True,
        embed_scale=True,
        max_seq=256,
    )
