"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision]: d=4096, 32
heads (GQA kv=8) head_dim 128, d_ff=14336 SwiGLU, vocab 128256, gated
cross-attention layers over 1600 precomputed image patch embeddings (the
``image_embeds`` input; the vision frontend is a stub).  The same values as
`repro.configs.llama32_vision_11b`, which says ``n_layers=40`` and "every 5th
layer" but whose `blocks` hold 32 layers, 8 runs of 3 self-attention layers
and one cross-attention layer: the layers JAX builds and runs, and so the
port (``n_layers`` still scales ``w_o``'s init, as in JAX).  ~8.0 B
parameters (~16 GB of bf16): its card runs keep every layer."""

from ..models.config import ModelConfig
from .gemma_7b import FULL_ATTN_SKIP


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        blocks=(("attn", 3), ("xattn", 1)) * 8,
        act="silu",
        mlp_style="glu",
        rope_theta=500000.0,
        n_image_tokens=1600,
        skip_shapes=FULL_ATTN_SKIP,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        blocks=(("attn", 1), ("xattn", 1)) * 2,
        n_image_tokens=16,
        fsdp=False,
        remat=False,
    )
