"""Architecture registry (the counterpart of `repro.configs.registry`):
``--arch <id>`` lookup, the reduced smoke-test variants, the context
inputs of the cross-attention archs (`extra_inputs`) and the dry run's
(arch, shape) cells that an arch skips (`cell_status`).

`ARCHS` lists the archs the port runs: all ten of the JAX package's.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "gemma-7b",
    "qwen2-72b",
    "starcoder2-7b",
    "h2o-danube-3-4b",
    "arctic-480b",
    "deepseek-v3-671b",
    "zamba2-2.7b",
    "xlstm-125m",
    "llama-3.2-vision-11b",
    "seamless-m4t-large-v2",
]

_MODULES = {
    "gemma-7b": "gemma_7b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-7b": "starcoder2_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "arctic-480b": "arctic_480b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-125m": "xlstm_125m",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
    return importlib.import_module(f"{__package__}.{_MODULES[name]}")


def get_config(name: str, *, n_layers: int | None = None) -> ModelConfig:
    """`name`'s published config; `n_layers` keeps its first layers, across
    runs of block kinds, for an arch whose full depth does not fit one card
    (qwen2-72b: ~145 GB of bf16 weights against 80 GB; deepseek-v3-671b at 4
    layers is ``(("mla", 3), ("mla_moe", 1))``)."""
    cfg = _module(name).config()
    return cfg if n_layers is None else cut_layers(cfg, n_layers)


def cut_layers(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """`cfg` keeping its first `n_layers` layers, across runs of block kinds."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name}: cannot keep {n_layers} of {cfg.blocks}")
    blocks, left = [], n_layers
    for kind, count in cfg.blocks:
        if left:
            blocks.append((kind, min(count, left)))
            left -= blocks[-1][1]
    return cfg.replace(n_layers=n_layers, blocks=tuple(blocks))


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return _module(name).reduced()


def extra_inputs(cfg: ModelConfig, batch: int, seq: int) -> dict[str, tuple[tuple[int, ...], str]]:
    """The modality frontends' stub inputs of `cfg` for `batch` prompts of
    `seq` tokens: name -> (shape, dtype name), as JAX's.  The frontends (the
    image encoder, the speech feature extractor) are stubs; their
    precomputed embeddings are model inputs: ``audio_frames`` (B,
    min(seq, 4096), d) for an encoder-decoder, ``image_embeds`` (B,
    n_image_tokens, d) for an arch with ``xattn`` layers."""
    out: dict[str, tuple[tuple[int, ...], str]] = {}
    if cfg.encdec:
        out["audio_frames"] = ((batch, min(seq, 4096), cfg.d_model), cfg.dtype)
    if any(k == "xattn" for k, _ in cfg.blocks):
        out["image_embeds"] = ((batch, cfg.n_image_tokens, cfg.d_model), cfg.dtype)
    return out


def cell_status(cfg: ModelConfig, shape_name: str) -> str | None:
    """None if the (arch, shape) cell runs; otherwise the skip reason
    (``cfg.skip_shapes``)."""
    for sname, reason in cfg.skip_shapes:
        if sname == shape_name:
            return reason
    return None
