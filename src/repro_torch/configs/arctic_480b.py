"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base]: 35L, d=7168,
56 heads (GQA kv=8) head_dim 128; dense FFN residual (d_ff 4864) in
*parallel* with a 128-expert top-2 MoE (expert d_ff 4864).  The same values
as `repro.configs.arctic_480b`.  One layer is ~13.6 B parameters (27.2 GB
of bf16, almost all of it the 128 experts): its card runs cut the layers."""

from ..models.config import ModelConfig, MoEConfig
from .gemma_7b import FULL_ATTN_SKIP


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        blocks=(("moe", 35),),
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_parallel=True,
            router_style="softmax",
            norm_topk=True,
            capacity_factor=1.25,
        ),
        act="silu",
        mlp_style="glu",
        rope_theta=1e6,
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2,
        d_model=64,
        n_heads=6,
        n_kv_heads=2,
        head_dim=8,
        d_ff=96,
        vocab_size=512,
        blocks=(("moe", 2),),
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=96,
            dense_parallel=True,
            capacity_factor=64.0,
            decode_capacity_factor=64.0,
        ),
        fsdp=False,
        remat=False,
    )
