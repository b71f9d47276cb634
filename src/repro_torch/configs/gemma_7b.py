"""Gemma-7B [arXiv:2403.08295]: 28L, d=3072, 16 heads x head_dim 256 (MHA),
d_ff=24576 GeGLU, vocab 256000, tied + sqrt(d)-scaled embeddings,
(1+w)-style RMSNorm.  The same values as `repro.configs.gemma_7b`."""

from ..models.config import ModelConfig

FULL_ATTN_SKIP = (("long_500k", "pure full-attention arch: 500k dense KV out of scope (DESIGN §4)"),)


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        blocks=(("attn", 28),),
        act="gelu",
        mlp_style="glu",
        gemma_norm=True,
        tie_embeddings=True,
        scale_embed=True,
        rope_theta=10000.0,
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        blocks=(("attn", 2),),
        fsdp=False,
        remat=False,
    )
