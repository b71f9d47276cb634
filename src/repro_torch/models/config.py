"""Model configuration (the counterpart of `repro.models.config`).

A ModelConfig describes one architecture: the repeating layer pattern
(`blocks`, run-length encoded), the attention settings, the FFN and the
embedding/head layout.  It holds the JAX config's fields that the ported
blocks read: the MLA, MoE, SSM (Mamba2) and xLSTM sub-configs, Zamba's
``shared_attn_every``, the cross-attention layout (``cross_attn_layers``,
``n_image_tokens``), the encoder's (``encdec``, ``n_enc_layers``) and the
training settings ``remat`` (recompute each layer in the backward pass,
`lm.forward`) and ``z_loss`` (`layers.softmax_cross_entropy`), and the
sharding settings that `sharding.rules` reads (``fsdp``: weights stored
sharded over the data axis too; ``dp_over_model``: a pure data-parallel
arch whose batch is split over the model axis as well; the
``heads_shardable`` and ``kv_heads_shardable`` properties), and the
shapes an arch skips (``skip_shapes``, `configs.registry.cell_status`),
with JAX's defaults.  `SHAPES` holds JAX's four input-shape cells of the
dry run (`launch.dryrun`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared: int = 0  # DeepSeek shared experts
    d_ff_shared: int = 0
    dense_parallel: bool = False  # Arctic: dense FFN residual in parallel
    router_style: str = "softmax"  # softmax | sigmoid (dsv3 aux-free)
    norm_topk: bool = True
    capacity_factor: float = 1.25
    decode_capacity_factor: float = 4.0  # generous: decode batches are tiny
    act: str = "silu"
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3


@dataclass(frozen=True)
class SSMConfig:
    d_inner: int = 0
    d_state: int = 64
    d_conv: int = 4
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    d_inner_m: int = 0  # mLSTM inner dim (proj_factor * d)
    d_conv: int = 4
    chunk: int = 256
    slstm_layers: tuple[int, ...] = ()  # layer indices that use sLSTM


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern, run-length encoded: (("attn", 28),)
    blocks: tuple[tuple[str, int], ...] = ()

    # norms / activations / mlp
    norm: str = "rms"  # rms | layernorm
    gemma_norm: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    mlp_style: str = "glu"  # glu | plain
    qkv_bias: bool = False

    # attention
    causal: bool = True
    rope_theta: float = 10000.0
    rotary_dim: int | None = None
    window: int | None = None  # sliding-window attention
    attn_soft_cap: float | None = None
    attn_scale: float | None = None

    # sub-configs
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None

    # zamba-style shared transformer block, applied after every run of blocks
    shared_attn_every: int = 0

    # VLM cross-attention: the ``xattn`` layers attend over n_image_tokens
    # precomputed image embeddings (the ``image_embeds`` input)
    cross_attn_layers: tuple[int, ...] = ()
    n_image_tokens: int = 1600

    # encoder-decoder: n_enc_layers ``enc`` layers over the ``audio_frames``
    # input give the context the ``dec`` layers attend over
    encdec: bool = False
    n_enc_layers: int = 0

    # embeddings
    tie_embeddings: bool = False
    scale_embed: bool = False  # gemma multiplies embeddings by sqrt(d)

    dtype: str = "bfloat16"
    # sharding (`sharding.rules`): weights stored over the data axis too
    # (FSDP), and the batch split over the model axis as well (pure DP)
    fsdp: bool = True
    dp_over_model: bool = False
    # training: recompute each layer in the backward pass (JAX's jax.checkpoint)
    # and the weight of the mean squared log-partition in the loss
    remat: bool = True
    z_loss: float = 1e-4
    # KV positions per step of `attention.blockwise_attention` (above 8192)
    blockwise_chunk: int = 1024

    # shapes this arch skips in the dry run, and why: (shape name, reason)
    skip_shapes: tuple[tuple[str, str], ...] = ()

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def heads_shardable(self) -> bool:
        """Can the q heads be tensor-parallel over a 16-way model axis?"""
        return self.n_heads % 16 == 0

    @property
    def kv_heads_shardable(self) -> bool:
        return self.n_kv_heads % 16 == 0

    @property
    def block_list(self) -> list[str]:
        out: list[str] = []
        for kind, count in self.blocks:
            out.extend([kind] * count)
        return out

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry run (JAX's)."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
