"""Qwen2-72B [arXiv:2407.10671]: 80L, d=8192, 64 heads (GQA, 8 KV heads) x
head_dim 128, d_ff=29568 SwiGLU, vocab 152064, QKV bias, rope theta 1e6.
The same values as `repro.configs.qwen2_72b`.  At 2 bytes a parameter
(~145 GB) it does not fit one 80 GB card: its card runs cut the layers."""

from ..models.config import ModelConfig
from .gemma_7b import FULL_ATTN_SKIP


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        blocks=(("attn", 80),),
        act="silu",
        mlp_style="glu",
        qkv_bias=True,
        rope_theta=1e6,
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=160,
        vocab_size=512,
        blocks=(("attn", 2),),
        fsdp=False,
        remat=False,
    )
