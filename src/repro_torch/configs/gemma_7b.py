"""gemma-7b: 28L dense, MHA (kv=16), GeGLU, head_dim=256.
[arXiv:2403.08295; hf]

Port of ``repro/configs/gemma_7b.py``, the same numbers.
"""

from ..models.config import AttnConfig, FFNConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        d_model=3072,
        n_layers=28,
        vocab=256_000,
        attn=AttnConfig(n_heads=16, n_kv=16, head_dim=256, rope_theta=10_000.0),
        ffn=FFNConfig(d_ff=24_576, act="gelu", gated=True),
        tie_embeddings=True,
        embed_scale=True,
        max_seq=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        d_model=64,
        n_layers=3,
        vocab=512,
        attn=AttnConfig(n_heads=2, n_kv=2, head_dim=32, rope_theta=10_000.0),
        ffn=FFNConfig(d_ff=192, act="gelu", gated=True),
        tie_embeddings=True,
        embed_scale=True,
        max_seq=256,
    )
