"""Architecture registry (the counterpart of `repro.configs.registry`):
``--arch <id>`` lookup and the reduced smoke-test variants.

`ARCHS` lists the archs the port runs.  The JAX package's other archs wait
for the parts of the LM stack they need; asking for one raises `KeyError`
naming the ROADMAP step that ports it.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["gemma-7b"]

_MODULES = {"gemma-7b": "gemma_7b"}

# arch -> the step of ROADMAP Queue 2 item 8 (the LM stack) that ports it
_QUEUED = {
    "qwen2-72b": "step 1 (GQA archs)",
    "starcoder2-7b": "step 1 (GQA archs)",
    "h2o-danube-3-4b": "step 2 (sliding window and soft cap)",
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
            f"arch {name!r} is not ported yet: ROADMAP Queue 2 item 8, {_QUEUED[name]}; "
            f"ported: {ARCHS}"
        )
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
    return importlib.import_module(f"{__package__}.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    return _module(name).reduced()
