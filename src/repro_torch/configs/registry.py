"""Architecture registry (the counterpart of `repro.configs.registry`):
``--arch <id>`` lookup and the reduced smoke-test variants.

`ARCHS` lists the archs the port runs.  The JAX package's other archs wait
for the parts of the LM stack they need; asking for one raises `KeyError`
naming the ROADMAP step that ports it.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["gemma-7b", "qwen2-72b", "starcoder2-7b", "h2o-danube-3-4b"]

_MODULES = {
    "gemma-7b": "gemma_7b",
    "qwen2-72b": "qwen2_72b",
    "starcoder2-7b": "starcoder2_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
}

# arch -> the step of ROADMAP Queue 1 item 8 (the LM stack) that ports it
_QUEUED = {
    "arctic-480b": "step 4 (MoE)",
    "deepseek-v3-671b": "step 5 (MLA)",
    "zamba2-2.7b": "step 6 (Mamba2 and xLSTM)",
    "xlstm-125m": "step 6 (Mamba2 and xLSTM)",
    "llama-3.2-vision-11b": "step 7 (cross-attention and enc-dec)",
    "seamless-m4t-large-v2": "step 7 (cross-attention and enc-dec)",
}


def _module(name: str):
    if name in _QUEUED:
        raise KeyError(
            f"arch {name!r} is not ported yet: ROADMAP Queue 1 item 8, {_QUEUED[name]}; "
            f"ported: {ARCHS}"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
    return importlib.import_module(f"{__package__}.{_MODULES[name]}")


def get_config(name: str, *, n_layers: int | None = None) -> ModelConfig:
    """`name`'s published config; `n_layers` keeps its first layers (a run
    of one block kind), for an arch whose full depth does not fit one card
    (qwen2-72b: ~145 GB of bf16 weights against 80 GB)."""
    cfg = _module(name).config()
    if n_layers is None:
        return cfg
    if len(cfg.blocks) != 1 or not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"{name}: cannot keep {n_layers} of {cfg.blocks}")
    return cfg.replace(n_layers=n_layers, blocks=((cfg.blocks[0][0], n_layers),))


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return _module(name).reduced()
