"""SeamlessM4T-large-v2 [arXiv:2308.11596]: encoder-decoder, 24L encoder +
24L decoder, d=1024, 16 heads head_dim 64, d_ff=8192, vocab 256206.  The
speech frontend is a stub: the encoder takes precomputed frame embeddings
(the ``audio_frames`` input, (B, T_enc, d)).  RoPE replaces sinusoidal
positions, as in the JAX package.  The same values as
`repro.configs.seamless_m4t_v2`.  ~1.6 B parameters (~3.3 GB of bf16)."""

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        blocks=(("dec", 24),),
        encdec=True,
        n_enc_layers=24,
        act="gelu",
        mlp_style="plain",
        norm="layernorm",
        norm_eps=1e-5,
        skip_shapes=(("long_500k", "full-attention enc-dec: 500k decoder cache out of scope"),),
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
        blocks=(("dec", 2),),
        n_enc_layers=2,
        fsdp=False,
        remat=False,
    )
