"""LM serving steps (the LM half of `repro.serve.cv_engine`): prefill, greedy
decode against a KV cache, and the greedy `generate` loop.

Everything runs eagerly under `torch.inference_mode()` on one device; there
is no mesh and no sharding hint.  The KV cache is written in place
(`models.attention.gqa_decode`).  `CvEngine`, the fault-tolerant CV batch
engine of the JAX module, joins in ROADMAP Queue 2 item 7.
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..models import lm


def make_prefill_step(*, mode: str | None = None):
    """-> prefill_step(model, tokens (B, S)) -> (next token (B,) int32, cache).
    `mode` reaches the attention kernel (``"ref"``: its plain version)."""

    def prefill_step(model, tokens):
        logits, cache = lm.prefill(model, tokens, mode=mode)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step():
    """-> serve_step(model, cache, tokens (B, 1)) -> (next token (B,) int32,
    cache)."""

    def serve_step(model, cache, tokens):
        logits, cache = lm.decode_step(model, tokens, cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step


def generate(
    model: lm.LM,
    prompt_tokens,
    *,
    steps: int,
    cache_len: int | None = None,
    device=None,
    mode: str | None = None,
) -> torch.Tensor:
    """Greedy generation: prefill the (B, S) prompts, then decode; returns
    the (B, steps) int32 tokens.  Runs on `device` (None = "cuda"), where
    the model must lie; `mode` reaches the attention kernel of the prefill."""
    dev = resolve_device(device)
    here = model.device
    if here.type != dev.type or (dev.index is not None and here.index != dev.index):
        raise ValueError(f"generate: the model lies on {here}, not on {dev}")
    cfg = model.cfg
    with torch.inference_mode():
        prompt = torch.as_tensor(prompt_tokens, device=dev)
        B, S = prompt.shape
        cache_len = cache_len or (S + steps)
        decode = make_decode_step()
        tok, pcache = make_prefill_step(mode=mode)(model, prompt)
        # re-home the prefill cache into fixed-size decode buffers
        cache = _adopt_prefill(lm.init_cache(cfg, B, cache_len, device=dev), pcache, cfg)
        del pcache
        out = [tok]
        for _ in range(steps - 1):
            tok, cache = decode(model, cache, out[-1][:, None])
            out.append(tok)
        return torch.stack(out, dim=1)


def _adopt_prefill(cache: dict, pcache: dict, cfg) -> dict:
    """Copy the prefill KV (length S) into the decode buffers (length
    cache_len >= S), in place."""
    for (kind, _), buf, pre in zip(cfg.blocks, cache["groups"], pcache["groups"]):
        S, T = pre["k"].shape[2], buf["k"].shape[2]
        if S > T:
            raise NotImplementedError(
                f"{kind}: a prompt of {S} tokens over a {T}-slot cache needs the sliding "
                "window (ROADMAP Queue 2 item 8, step 2)"
            )
        for name in buf:
            buf[name][:, :, :S] = pre[name].to(buf[name].dtype)
    return dict(cache, pos=pcache["pos"])
