"""H2O-Danube3-4B [arXiv:2401.16818 lineage]: 24L, d=3840, 32 heads (GQA,
8 KV heads) x head_dim 120, d_ff=10240 SwiGLU, vocab 32000, sliding-window
attention over 4096 positions (decode keeps a ring of 4096 slots).  The
same values as `repro.configs.h2o_danube3_4b`."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab_size=32000,
        blocks=(("attn", 24),),
        act="silu",
        mlp_style="glu",
        window=4096,
        rope_theta=10000.0,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        blocks=(("attn", 2),),
        window=32,
        fsdp=False,
        remat=False,
    )
