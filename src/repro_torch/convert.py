"""Carry a trained model, or a language model's parameters, across from the
JAX package.

`from_jax_model` takes plain numpy arrays (what ``np.asarray(model.centroids)``,
``np.asarray(model.svm["w"])`` and ``np.asarray(model.svm["b"])`` give for a
`repro.cv.pipeline.BowSvmModel`), and `from_jax_gbdt_model` those of a
`repro.cv.pipeline.BowGbdtModel` (``model.centroids`` and
``model.gbdt.{feat, thr, leaf, base}``), so both packages compute with the
same model and this package never imports JAX.  `from_jax_lm_params` takes
the parameter tree of `repro.models.lm.init_params` as nested dicts and
lists of numpy arrays (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .cv.gbdt import GbdtModel
from .cv.pipeline import BowGbdtModel, BowSvmModel
from .models.lm import LM


def from_jax_model(centroids, w, b, n_classes: int, *, device=None) -> BowSvmModel:
    """numpy centroids (K, D), w (C, K), b (C,) -> the port's `BowSvmModel`
    on `device` (None = "cuda")."""
    dev = resolve_device(device)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    centroids, w, b = f32(centroids), f32(w), f32(b)
    if centroids.ndim != 2 or w.shape != (n_classes, centroids.shape[0]) or b.shape != (n_classes,):
        raise ValueError(
            f"from_jax_model: shapes {tuple(centroids.shape)} / {tuple(w.shape)} / "
            f"{tuple(b.shape)} do not form a {n_classes}-class model"
        )
    return BowSvmModel(centroids, w, b, n_classes)


def from_jax_gbdt_model(
    centroids, feat, thr, leaf, base, n_classes: int, *, device=None
) -> BowGbdtModel:
    """numpy centroids (K, D), feat (T, depth) int, thr (T, depth),
    leaf (T, 2^depth, C), base (C,) -> the port's `BowGbdtModel` on
    `device` (None = "cuda").  Every feature index must name a word."""
    dev = resolve_device(device)
    centroids = np.array(centroids, dtype=np.float32)
    feat_i = np.array(feat)
    thr, leaf, base = (np.array(a, dtype=np.float32) for a in (thr, leaf, base))
    if (
        centroids.ndim != 2
        or feat_i.ndim != 2
        or not np.issubdtype(feat_i.dtype, np.integer)
        or thr.shape != feat_i.shape
        or leaf.shape != (feat_i.shape[0], 2 ** feat_i.shape[1], n_classes)
        or base.shape != (n_classes,)
    ):
        raise ValueError(
            f"from_jax_gbdt_model: shapes {centroids.shape} / feat {feat_i.shape} "
            f"{feat_i.dtype} / thr {thr.shape} / leaf {leaf.shape} / base {base.shape} "
            f"do not form a {n_classes}-class model"
        )
    if feat_i.size and (feat_i.min() < 0 or feat_i.max() >= centroids.shape[0]):
        raise ValueError(
            f"from_jax_gbdt_model: feature indices must lie in [0, {centroids.shape[0]})"
        )
    gbdt = GbdtModel(feat_i.astype(np.int32), thr, leaf, base, n_classes)
    return BowGbdtModel(torch.from_numpy(centroids), gbdt, n_classes).to(dev)


def _leaves(tree, prefix: str = ""):
    """(dotted path, array) of every leaf of a nested dict."""
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, dict):
            yield from _leaves(sub, f"{path}.")
        else:
            yield path, sub


def from_jax_lm_params(params: dict, cfg, *, device=None) -> LM:
    """The JAX parameter tree of `cfg`'s language model -> the port's `LM`
    on `device` (None = "cuda").  Each run of layers is stacked on a leading
    axis in JAX and is unstacked into one module per layer.  bf16 arrives as
    ``ml_dtypes.bfloat16``, which torch does not take: every array is widened
    to f32 in numpy and cast to its parameter's dtype, a round trip that is
    exact.  Nested trees carry over by their dotted paths: the MoE FFN's
    (L, E, D, F) expert stacks, ``router``, ``router_bias``, ``shared.*``,
    Arctic's ``dense_mlp.*`` and ``ln_dense.*``, MLA's ``q_norm.scale`` and
    ``kv_norm.scale``, the state kinds' ``mixer.*`` and ``cell.*`` (with
    ``cell.ffn.*`` and the sLSTM's (L, 4, NH, DH, DH) ``cell.r_gates``),
    ``xattn``'s scalar gates ``attn.gate_attn`` and ``gate_mlp`` ((L,) in
    JAX), ``dec``'s ``ln_x.*`` and ``xattn.*``, Zamba's ``shared_block.*``,
    which JAX does not stack, and the encoder's ``encoder.groups[0]``
    (stacked, into ``encoder.blocks.<i>``) and ``encoder.final_norm.*``.
    The tree must name exactly the model's parameters."""
    dev = resolve_device(device)
    model = LM(cfg, device="meta").to_empty(device=dev)
    flat = {}
    for name in ("embed", "lm_head"):
        if name in params:
            flat[name] = params[name]
    for name in ("final_norm", "shared_block"):  # not stacked
        if name in params:
            flat.update(_leaves(params[name], f"{name}."))
    runs = [("blocks", kind, count, group)
            for (kind, count), group in zip(cfg.blocks, params["groups"], strict=True)]
    if "encoder" in params:
        enc = params["encoder"]
        flat.update(_leaves(enc["final_norm"], "encoder.final_norm."))
        runs += [("encoder.blocks", "enc", cfg.n_enc_layers, g) for g in enc["groups"]]
    first = dict.fromkeys(("blocks", "encoder.blocks"), 0)
    for where, kind, count, group in runs:
        for path, arr in _leaves(group):
            if len(arr) != count:
                raise ValueError(f"from_jax_lm_params: {kind} {path} stacks {len(arr)} of {count}")
            for li in range(count):
                flat[f"{where}.{first[where] + li}.{path}"] = arr[li]
        first[where] += count
    state = model.state_dict()
    if set(flat) != set(state):
        raise ValueError(
            "from_jax_lm_params: the tree does not match the model: missing "
            f"{sorted(set(state) - set(flat))}, extra {sorted(set(flat) - set(state))}"
        )
    with torch.no_grad():
        for name, arr in flat.items():
            a = np.array(arr, dtype=np.float32)
            if a.shape != tuple(state[name].shape):
                raise ValueError(
                    f"from_jax_lm_params: {name} has shape {a.shape}, "
                    f"the model {tuple(state[name].shape)}"
                )
            state[name].copy_(torch.from_numpy(a))
    return model
