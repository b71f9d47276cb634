"""DeepSeek-V3-671B [arXiv:2412.19437]: 61L, d=7168, MLA with 128 heads
(q_lora 1536, kv_lora 512, nope 128, rope 64, v 128); first 3 layers dense
(d_ff 18432), remaining 58 layers MoE: 256 routed experts d_ff=2048 top-8 +
1 shared expert, sigmoid router with aux-free bias balancing.  MTP
omitted.  The same values as `repro.configs.deepseek_v3_671b`.  Its card
runs cut the layers: 4 (3 dense MLA, 1 MLA-MoE) are ~15.1 B parameters."""

from ..models.config import MLAConfig, ModelConfig, MoEConfig
from .gemma_7b import FULL_ATTN_SKIP


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,
        vocab_size=129280,
        blocks=(("mla", 3), ("mla_moe", 58)),
        mla=MLAConfig(
            q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128
        ),
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            d_ff_expert=2048,
            n_shared=1,
            d_ff_shared=2048,
            router_style="sigmoid",
            capacity_factor=1.25,
        ),
        act="silu",
        mlp_style="glu",
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        blocks=(("mla", 1), ("mla_moe", 2)),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff_expert=32,
            n_shared=1,
            d_ff_shared=32,
            router_style="sigmoid",
            capacity_factor=64.0,
            decode_capacity_factor=64.0,
        ),
        fsdp=False,
        remat=False,
    )
