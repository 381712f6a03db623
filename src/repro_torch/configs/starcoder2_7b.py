"""starcoder2-7b: 32L dense GQA code LM.  [arXiv:2402.19173; hf]

GQA kv=4, RoPE; plain-GELU (ungated) MLP per the StarCoder2 paper.

Port of ``repro/configs/starcoder2_7b.py``, the same numbers.
"""

from ..models.config import AttnConfig, FFNConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        d_model=4608,
        n_layers=32,
        vocab=49_152,
        attn=AttnConfig(n_heads=36, n_kv=4, head_dim=128, rope_theta=100_000.0),
        ffn=FFNConfig(d_ff=18_432, act="gelu", gated=False),
        tie_embeddings=False,
        max_seq=16_384,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        d_model=64,
        n_layers=3,
        vocab=512,
        attn=AttnConfig(n_heads=4, n_kv=2, head_dim=16, rope_theta=100_000.0),
        ffn=FFNConfig(d_ff=128, act="gelu", gated=False),
        tie_embeddings=False,
        max_seq=256,
    )
