"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba2 layers, d=2560 (d_inner 5120,
ssm_state 64, head_dim 64 -> 80 SSM heads), plus one *shared* transformer
block (32 heads, kv=32, head_dim 80, d_ff 10240) applied after every run of
6 Mamba2 layers, 9 applications.  The same values as
`repro.configs.zamba2_2p7b`.  ~2.6 B parameters (~5.2 GB of bf16): its card
runs keep every layer."""

from ..models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        blocks=(("mamba", 6),) * 9,
        shared_attn_every=6,
        ssm=SSMConfig(d_inner=5120, d_state=64, d_conv=4, head_dim=64, n_groups=1, chunk=256),
        act="gelu",
        mlp_style="glu",
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        blocks=(("mamba", 2),) * 2,
        shared_attn_every=2,
        ssm=SSMConfig(d_inner=128, d_state=16, d_conv=4, head_dim=32, n_groups=1, chunk=16),
        fsdp=False,
        remat=False,
    )
