"""StarCoder2-7B [arXiv:2402.19173]: 32L, d=4608, 36 heads (GQA, 4 KV heads)
x head_dim 128, d_ff=18432 plain-GELU MLP, LayerNorm (eps 1e-5), biases,
vocab 49152, rope theta 1e5.  The same values as
`repro.configs.starcoder2_7b`."""

from ..models.config import ModelConfig
from .gemma_7b import FULL_ATTN_SKIP


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        blocks=(("attn", 32),),
        act="gelu",
        mlp_style="plain",
        qkv_bias=True,
        norm="layernorm",
        norm_eps=1e-5,
        rope_theta=1e5,
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=72,
        n_heads=6,
        n_kv_heads=2,
        head_dim=12,
        d_ff=144,
        vocab_size=512,
        blocks=(("attn", 2),),
        fsdp=False,
        remat=False,
    )
