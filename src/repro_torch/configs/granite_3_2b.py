"""granite-3-2b: 40L dense GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]

Port of ``repro/configs/granite_3_2b.py``, the same numbers.
"""

from ..models.config import AttnConfig, FFNConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        d_model=2048,
        n_layers=40,
        vocab=49_155,
        attn=AttnConfig(n_heads=32, n_kv=8, head_dim=64, rope_theta=10_000.0),
        ffn=FFNConfig(d_ff=8192, act="silu", gated=True),
        tie_embeddings=True,
        max_seq=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        d_model=64,
        n_layers=4,
        vocab=515,  # deliberately non-round, like the real 49155
        attn=AttnConfig(n_heads=4, n_kv=2, head_dim=16, rope_theta=10_000.0),
        ffn=FFNConfig(d_ff=128, act="silu", gated=True),
        tie_embeddings=True,
        max_seq=256,
    )
