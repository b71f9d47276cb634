"""xLSTM-125M [arXiv:2405.04517]: 12 blocks, d=768, 4 heads, vocab 50304,
d_ff=0 (mLSTM blocks carry their own 2x up-projection, sLSTM blocks a 4/3
gated FFN); sLSTM at 2 of the 12 positions, the embedding tied to the head.
The same values as `repro.configs.xlstm_125m`.  ~0.16 B parameters: its
card runs keep every layer."""

from ..models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        head_dim=192,
        d_ff=0,
        vocab_size=50304,
        blocks=(("mlstm", 4), ("slstm", 1), ("mlstm", 6), ("slstm", 1)),
        xlstm=XLSTMConfig(n_heads=4, d_inner_m=1536, d_conv=4, chunk=256),
        tie_embeddings=True,
        fsdp=False,
        dp_over_model=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        vocab_size=512,
        blocks=(("mlstm", 2), ("slstm", 1)),
        xlstm=XLSTMConfig(n_heads=2, d_inner_m=128, d_conv=4, chunk=16),
        fsdp=False,
        remat=False,
    )
