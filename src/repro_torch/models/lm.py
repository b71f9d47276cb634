"""Top-level language model (the counterpart of `repro.models.lm`): the
embedding, the layers and the head, the training forward and the two
serving entry points.

  forward(model, tokens, extras=None)  -> (logits, metrics)       [train]
  prefill(model, tokens, extras=None)  -> (last_logits, cache)    [serving]
  decode_step(model, tokens, cache)    -> (logits, cache)         [serving]

`LM` holds the parameters as modules named like the JAX parameter tree,
with one module per layer where JAX stacks each homogeneous run of layers
on a leading axis (`convert.from_jax_lm_params` unstacks it).  The cache
keeps JAX's layout: per run of layers, each entry of a layer's cache
stacked on a leading axis (``k`` and ``v`` (L, B, T, G, hd); MLA's ``ckv``
(L, B, T, r_kv) and ``kr`` (L, B, T, rope_dim); a state kind's f32 state,
e.g. Mamba2's ``ssm`` (L, B, H, N, P) and ``conv`` (L, B, K - 1, C); the
context's K / V of ``xattn`` (``k``, ``v``) and ``dec`` (``xk``, ``xv``),
(L, B, T_ctx, G, hd)); under ``shared``, one ``{"k", "v"}`` (B, T, G, hd)
entry for each application of Zamba's shared block; and the next position
``pos`` (a Python int here).  JAX's cache also keeps the context itself
under ``ctx``, which its decode never reads; the port's does not.  With
``cfg.shared_attn_every`` set, `LM.shared_block` (one ``"attn"`` block)
runs after every run of `cfg.blocks`, as in JAX.

The cross-attention archs take a context input (`extras`, JAX's batch
entries beside the tokens; `configs.extra_inputs` names them):
``image_embeds`` (B, n_image_tokens, D), cast to the weights' dtype, for
the ``xattn`` layers; ``audio_frames`` (B, T_enc, D) for an
encoder-decoder, whose encoder (`LM.encoder`: ``n_enc_layers`` ``enc``
blocks and its ``final_norm``) turns them into the context of the ``dec``
layers (`_run_encoder`).

`forward` returns every position's logits and JAX's merged MoE metrics.
With ``cfg.remat`` set and grad enabled, each layer (the encoder's too)
runs under `torch.utils.checkpoint` (JAX's ``jax.checkpoint`` of the scan
body): its activations are recomputed in the backward pass, and its
attention kernel launches again there.  The parameters are frozen as
built; `make_trainable` turns on their gradients for training (all but the
sigmoid router's ``router_bias``, which JAX reaches only through a
``stop_gradient`` and `train.step` updates by its own rule).

On a mesh (`shard_model`, then the entry points with ``hint=`` a
`sharding.rules.make_hint`): each parameter is stored as a DTensor with
the placements of `sharding.rules.param_specs` (JAX's memory layout: FSDP
over "data" when ``cfg.fsdp``, TP over "model", the MoE expert stacks over
("data", "model")).  Each rank computes its part of the batch
(`sharding.rules.shard_batch`: `forward` and `prefill` take the global
batch, which every rank holds, and return the rank's rows), and the ranks
of the model axis split that part's work as JAX's hint table lays it out
(`sharding.rules.model_layout`, "tp" or "sp"): the hidden states are the
rank's slice of the sequence between layers (``"act"``), the embedding,
the head and the loss vocab-parallel (`_embed`, `_head`,
`layers.softmax_cross_entropy_vp`), and a layer's parameters are gathered
where it reads them (a tensor-parallel one over "data" only), inside its
remat'd function, so the backward pass gathers them again
(`sharding.comm.gather_param`).  A decode step splits its rows' work over
the model axis as JAX lays it out (`sharding.rules.decode_layout`): the
cache's time axis over "model" where `sharding.rules.cache_specs` splits
it (each rank attends over its slots, the softmax merged over the axis:
split-K), under "tp" the heads and FFN hidden too, the embedding and head
vocab-parallel, the MoE experts where they lie.  On a mesh the cache holds
the rank's part of each entry (`init_cache(mesh=)`, and `prefill`'s for
its S positions) and, under ``global``, the global batch and each time
entry's global slots, which a local tensor cannot tell.  The attention
kernel and every other kernel see plain local tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..sharding import comm
from ..sharding import rules
from . import blocks as blocks_mod
from . import ssm as ssm_mod
from .layers import apply_norm, dense_init, embed_init, init_norm

def sharded(hint) -> bool:
    """Does `hint` run the model on a mesh?"""
    return getattr(hint, "mesh", None) is not None


class Gathered:
    """A module's parameters as a layer reads them on a mesh: item, key and
    attribute access as on the module, each DTensor parameter gathered at
    its first read (`sharding.comm.gather_param`) and kept for the view's
    life, each sub-module a view in turn; `local` gives a parameter's local
    part instead (`sharding.comm.local_param`).  A leaf named in `keep`
    (`rules.local_leaves`: the tensor-parallel layout's) is gathered over
    the axes `rules.gather_axes` gives, keeping its "model" shard; the
    recurrent mixers (`rules.WHOLE_MODULES`) read every leaf whole, but the
    Mamba2 mixer's ``out_proj`` under the SSD heads' split
    (`rules.module_leaves`)."""

    __slots__ = ("_m", "_seen", "_keep")

    def __init__(self, module: nn.Module, keep: frozenset = frozenset()):
        self._m = module
        self._seen = {}
        self._keep = keep

    def _wrap(self, key, v):
        from torch.distributed.tensor import DTensor

        if not isinstance(v, (DTensor, nn.Module)):
            return v
        if key not in self._seen:
            if isinstance(v, nn.Module):
                self._seen[key] = Gathered(v, rules.module_leaves(key, self._keep))
            else:
                axes = rules.gather_axes(v.device_mesh, key, v.ndim, self._keep)
                self._seen[key] = comm.gather_param(v, axes)
        return self._seen[key]

    def __getitem__(self, key):
        return self._wrap(key, self._m[key])

    def __getattr__(self, key):
        return self._wrap(key, getattr(self._m, key))

    def __contains__(self, key) -> bool:
        return key in self._m

    def local(self, key) -> torch.Tensor:
        return comm.local_param(self._m[key])


def _check_sharded(model, hint) -> None:
    """A sharded `hint` needs `shard_model`'s model: the layers read its
    parameters as the hint's layout lays them out."""
    if sharded(hint) and getattr(model, "mesh", None) is None:
        raise ValueError("a sharded hint needs the model stored on its mesh (lm.shard_model)")


def _at(module, hint):
    """`module` as a layer reads it: a `Gathered` view on a mesh."""
    return Gathered(module, rules.local_leaves(hint)) if sharded(hint) else module


# slots of each shared-block application's KV ring (JAX `lm.init_cache`:
# a windowed cache, DESIGN §4 of the JAX package)
SHARED_ATTN_SLOTS = 4096


def _model_device(device) -> torch.device:
    """`resolve_device`, and the meta device for a model whose parameters
    are filled in afterwards (`convert.from_jax_lm_params`) or that is only
    traced (`launch.dryrun`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class LM(nn.Module):
    """The parameters of a `ModelConfig`'s language model on `device`
    (None = "cuda"), drawn from `generator` (a generator of that device;
    None = torch's default): JAX's initializers, not JAX's numbers."""

    def __init__(self, cfg, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        for kind, _ in cfg.blocks:
            blocks_mod.check_kind(kind)
        dev = _model_device(device)
        init = dict(device=dev, generator=generator)
        self.cfg = cfg
        self.embed = embed_init(cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, **init)
        self.blocks = nn.ModuleList(blocks_mod.init_block(k, cfg, **init) for k in cfg.block_list)
        self.final_norm = init_norm(
            cfg.d_model, kind=cfg.norm, gemma_style=cfg.gemma_norm, device=dev
        )
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(
                (cfg.d_model, cfg.vocab_size), dtype=cfg.param_dtype, scale=0.02, **init
            )
        if cfg.shared_attn_every:
            self.shared_block = blocks_mod.init_block("attn", cfg, **init)
        if cfg.encdec:
            self.encoder = nn.ModuleDict({
                "blocks": nn.ModuleList(
                    blocks_mod.init_block("enc", cfg, **init) for _ in range(cfg.n_enc_layers)),
                "final_norm": init_norm(
                    cfg.d_model, kind=cfg.norm, gemma_style=cfg.gemma_norm, device=dev),
            })

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def groups(self):
        """(kind, the run's layer modules) for each run of `cfg.blocks`."""
        i = 0
        for kind, count in self.cfg.blocks:
            yield kind, self.blocks[i : i + count]
            i += count


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _norm(cfg) -> dict:
    return dict(kind=cfg.norm, eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)


def _layout(hint) -> str | None:
    return getattr(hint, "layout", None)


def _embed(model: LM, tokens: torch.Tensor, hint=None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D); under a model layout (`rules.model_layout`)
    the rank's slice of the sequence (B, S / m, D): vocab-parallel, each rank
    looks its vocab rows up, zeros for the others, and the sums are
    reduce-scattered over the sequence; with the vocabulary whole, the
    slice's tokens are looked up.  In decode (``hint.decode``) the rows are
    whole on every rank: the vocab-parallel sums are summed over the axis."""
    table = _at(model, hint).embed
    if _layout(hint) is None:
        x = table[tokens]
    elif hint.vocab_parallel:
        rows = table.shape[0]
        idx = tokens - hint.model_rank * rows
        ok = (idx >= 0) & (idx < rows)
        x = table[idx.clamp(0, rows - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        # decode: the rows whole on every rank, the one rank's row plus zeros
        x = comm.sum_over(x, hint.seq_group) if hint.decode else comm.scatter_dim(
            x, 1, hint.seq_group)
    elif hint.decode:
        x = table[tokens]
    else:
        x = table[comm.slice_dim(tokens, 1, hint.seq_group)]
    if model.cfg.scale_embed:
        # JAX rounds sqrt(d) to the weight dtype first: 55.5 in bf16 at d 3072
        # (and so does a bf16 model whose weights were widened to f32)
        scale = torch.tensor(math.sqrt(model.cfg.d_model), dtype=model.cfg.param_dtype)
        x = x * scale.to(device=x.device, dtype=x.dtype)
    return x


def _head(model: LM, h: torch.Tensor, hint=None) -> torch.Tensor:
    """The final norm and the logits; under a model layout `h` is the
    rank's slice of the sequence, normed there: vocab-parallel, it is
    gathered and the logits come out in JAX's ``"logits"`` layout, (B, S,
    V / m), the rank's vocab shard; with the vocabulary whole, the logits
    are the slice's, (B, S / m, V) (`logits_layout`)."""
    cfg = model.cfg
    model = _at(model, hint)
    h = apply_norm(h, model.final_norm, **_norm(cfg))
    if getattr(hint, "vocab_parallel", False) and not hint.decode:
        h = comm.gather_dim(h, 1, hint.seq_group)
    if cfg.tie_embeddings:
        return h @ model.embed.T
    return h @ model.lm_head


def logits_layout(hint) -> int | None:
    """The dimension of `forward_local`'s logits that the model axis splits
    under `hint`: 2 (the vocabulary) vocab-parallel, 1 (the sequence) under
    a layout with the vocabulary whole, else None."""
    if _layout(hint) is None:
        return None
    return 2 if hint.vocab_parallel else 1


def _last_logits(model: LM, h: torch.Tensor, hint=None) -> torch.Tensor:
    """The last position's logits (B, V): under a model layout the last
    rank's slice ends the sequence, and a vocab-parallel head's shards are
    gathered over the vocabulary (for the argmax)."""
    if _layout(hint) is None:
        return _head(model, h[:, -1:, :], hint)[:, 0]
    seq = hint.seq_group
    last = comm.all_gather(h[:, -1:, :], 1, seq)[:, -1:, :]
    cfg = model.cfg
    mv = _at(model, hint)
    x = apply_norm(last, mv.final_norm, **_norm(cfg))
    logits = x @ (mv.embed.T if cfg.tie_embeddings else mv.lm_head)
    if hint.vocab_parallel:
        logits = comm.all_gather(logits, 2, seq)
    return logits[:, 0]


def make_trainable(model: LM) -> LM:
    """Turn on the gradient of every parameter but ``router_bias`` (JAX's
    gradient of it is 0: it reaches the loss only through the top-k's
    ``stop_gradient``).  Returns `model`."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.rsplit(".", 1)[-1] != "router_bias")
    return model


class Leaf(NamedTuple):
    """One leaf of JAX's parameter tree: its dotted path (``embed``,
    ``groups.0.attn.w_q``, ``encoder.groups.0.ln1.scale``) and the port's
    parameters it holds, one a layer where JAX stacks a run of layers on a
    leading axis (`stacked`)."""

    name: str
    params: list
    stacked: bool


def _leaf_key(name: str) -> tuple:
    # JAX flattens dict keys in sorted order and list entries by index
    return tuple(int(c) if c.isdigit() else c for c in name.split("."))


def param_leaves(model: LM) -> list[Leaf]:
    """The model's parameters as JAX's parameter tree holds them, in JAX's
    flattening order: a run of ``cfg.blocks`` is ``groups.<run>``, the
    encoder's layers ``encoder.groups.0``, each stacked over its layers; the
    rest (embedding, head, final norms, Zamba's shared block) one tensor a
    leaf.  The optimizers read the stacking (`optim.adamw`): JAX's weight
    decay and Adafactor factoring go by the rank of the stacked leaf."""
    run_of = []
    for gi, (_, count) in enumerate(model.cfg.blocks):
        run_of += [gi] * count
    leaves: dict[str, Leaf] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            key, stacked = ".".join(["groups", str(run_of[int(parts[1])]), *parts[2:]]), True
        elif parts[:2] == ["encoder", "blocks"]:
            key, stacked = ".".join(["encoder", "groups", "0", *parts[3:]]), True
        else:
            key, stacked = name, False
        leaves.setdefault(key, Leaf(key, [], stacked)).params.append(p)
    return [leaves[k] for k in sorted(leaves, key=_leaf_key)]


def shard_model(model: LM, mesh) -> LM:
    """Store each parameter of `model` as a DTensor on `mesh`, in place,
    with the placements of `sharding.rules.param_specs` (a layer's
    parameter: its leaf's spec without the layer axis) -> `model`, whose
    ``mesh`` is then set.  Every rank holds the same full model before (the
    same seed); a rank keeps its parts only."""
    specs = rules.param_specs(param_leaves(model), model.cfg, mesh)
    where = {id(p): (lf.name, lf.stacked) for lf in param_leaves(model) for p in lf.params}
    for mod in model.modules():
        for pname, p in list(mod._parameters.items()):
            name, stacked = where[id(p)]
            spec = rules.P(*specs[name][1:]) if stacked else specs[name]
            pl = rules.placements(spec, mesh)
            mod._parameters[pname] = nn.Parameter(
                rules.shard_tensor(p.detach(), mesh, pl), requires_grad=p.requires_grad)
    model.mesh = mesh
    return model


def _layer(kind: str, p, h: torch.Tensor, cfg, *, ctx=None, mode=None, hint=None):
    """One layer's full-sequence apply for `forward` -> (h, metrics), its
    cache entry dropped; under `torch.utils.checkpoint` when ``cfg.remat``
    is set and grad is enabled (on a mesh its parameters are gathered
    inside, so the recompute gathers them again)."""

    def run(h, ctx):
        out, _, metrics = blocks_mod.apply_block(kind, _at(p, hint), h, cfg, ctx=ctx, mode=mode,
                                                 hint=hint)
        return out, metrics

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(run, h, ctx, use_reentrant=False)
    return run(h, ctx)


def _run_encoder(model: LM, frames: torch.Tensor, *, mode: str | None = None,
                 hint=None) -> torch.Tensor:
    """The encoder over `frames` (B, T, D), in the weights' dtype, positions
    from 0 -> the final-normed context (B, T, D), whole on every rank.
    Under a model layout of T positions it runs on the rank's slice of the
    frames, as the decoder's layers do, and its output is gathered."""
    if sharded(hint):
        hint = hint.at(frames.shape[1])
    h = frames.to(model.embed.dtype)
    if _layout(hint) is not None:
        h = comm.slice_dim(h, 1, hint.seq_group)
    for p in model.encoder["blocks"]:
        h, _ = _layer("enc", p, h, model.cfg, mode=mode, hint=hint)
    h = apply_norm(h, _at(model.encoder["final_norm"], hint), **_norm(model.cfg))
    return comm.gather_dim(h, 1, hint.seq_group) if _layout(hint) is not None else h


def context_input(cfg) -> str | None:
    """The context input `cfg`'s prefill takes (`configs.extra_inputs`):
    ``audio_frames``, ``image_embeds`` or None."""
    if cfg.encdec:
        return "audio_frames"
    if cfg.cross_attn_layers or any(k == "xattn" for k, _ in cfg.blocks):
        return "image_embeds"
    return None


def context_len(cfg, extras: dict | None, batch: int) -> int | None:
    """Rows of the context (the cache's ``ctx_len``) that `extras` give
    `batch` prompts of `cfg`; None for an arch without one.  Raises
    `ValueError` if the input is missing or is not (batch, T, d_model)."""
    name = context_input(cfg)
    if name is None:
        return None
    t = (extras or {}).get(name)
    if t is None or t.ndim != 3 or t.shape[0] != batch or t.shape[2] != cfg.d_model:
        got = None if t is None else tuple(t.shape)
        raise ValueError(
            f"{cfg.name} needs the context input {name!r} of shape ({batch}, T, {cfg.d_model}) "
            f"(configs.extra_inputs), got {got}"
        )
    return t.shape[1]


def _context(model: LM, extras: dict | None, batch: int, *, mode: str | None = None,
             hint=None):
    """Cross-attention context: the image embeddings (VLM) or the encoder's
    output, in the weights' dtype (JAX: ``cfg.param_dtype``, the same unless
    the weights were widened); None for an arch without one."""
    if context_len(model.cfg, extras, batch) is None:
        return None
    x = extras[context_input(model.cfg)].to(model.device)
    if model.cfg.encdec:
        return _run_encoder(model, x, mode=mode, hint=hint)
    return x.to(model.embed.dtype)


def _merge_metrics(all_metrics: list) -> dict:
    """JAX's merge: per run of layers, each metric stacked over its layers
    and averaged over them (the scalars and the (E,) ``expert_load``
    alike), then summed over the runs."""
    agg: dict = {}
    for run in all_metrics:
        if not run or not run[0]:
            continue
        for k in run[0]:
            red = torch.mean(torch.stack([m[k] for m in run]), dim=0)
            agg[k] = agg[k] + red if k in agg else red
    return agg


# ---------------------------------------------------------------------------
# Full-sequence forward (training)
# ---------------------------------------------------------------------------


def local_batch(batch: dict, hint):
    """On a mesh: this rank's rows of a global batch (`rules.shard_batch`)
    and `hint` knowing the global batch size and the call's layout
    (`rules.model_layout` of the tokens' length); else both as given."""
    if not sharded(hint):
        return batch, hint
    n, S = batch["tokens"].shape
    return (rules.shard_batch(batch, hint.mesh, hint.cfg),
            dataclasses.replace(hint.at(S), batch=n))


def forward(model: LM, tokens: torch.Tensor, *, extras: dict | None = None,
            mode: str | None = None, hint=None):
    """tokens (B, S) -> (logits (B, S, V), metrics): positions from 0,
    Zamba's shared block after every run of layers, each layer remat'd when
    ``cfg.remat`` is set and grad is enabled (module docstring).  The
    metrics are the MoE layers' merged as JAX's `_merge_metrics` (empty for
    a dense arch).  `extras` and `mode` as in `prefill`.  With a sharded
    `hint` the model is `shard_model`'s, `tokens` and `extras` the global
    batch, and the logits and metrics this rank's rows' (the logits whole
    over the vocabulary)."""
    batch, hint = local_batch({"tokens": tokens, **(extras or {})}, hint)
    tokens = batch.pop("tokens")
    logits, metrics = forward_local(model, tokens, extras=batch or None, mode=mode, hint=hint)
    split = logits_layout(hint)
    if split is not None:
        logits = comm.gather_dim(logits, split, hint.seq_group)
    return logits, metrics


def forward_local(model: LM, tokens: torch.Tensor, *, extras: dict | None = None,
                  mode: str | None = None, hint=None):
    """`forward` on this rank's rows (`local_batch`), the logits split over
    the model axis as `logits_layout` says: under a vocab-parallel hint the
    rank's vocab shard (B, S, V / m), JAX's ``"logits"`` layout; under a
    layout with the vocabulary whole, the rank's slice of the sequence (B,
    S / m, V) (`_head`)."""
    _check_sharded(model, hint)
    cfg = model.cfg
    B, S = tokens.shape
    ctx = _context(model, extras, B, mode=mode, hint=hint)
    h = _embed(model, tokens, hint)
    metrics_list = []
    for kind, layers in model.groups():
        run = []
        for p in layers:
            h, m = _layer(kind, p, h, cfg, ctx=ctx, mode=mode, hint=hint)
            run.append(m)
        metrics_list.append(run)
        if cfg.shared_attn_every:
            h, _, _ = blocks_mod.apply_block("attn", _at(model.shared_block, hint), h, cfg,
                                             mode=mode, hint=hint)
    return _head(model, h, hint), _merge_metrics(metrics_list)


# ---------------------------------------------------------------------------
# Prefill: forward + cache extraction
# ---------------------------------------------------------------------------


def prefill(model: LM, tokens: torch.Tensor, *, extras: dict | None = None,
            mode: str | None = None, hint=None):
    """tokens (B, S) -> (logits of the last position (B, V), cache).
    `extras` holds the context input of a cross-attention arch (module
    docstring).  `mode` reaches the attention kernel (``"ref"``: its plain
    version).  The MoE metrics are dropped, as JAX's prefill drops them.
    With a sharded `hint`, as in `forward`: the logits are this rank's
    rows' (the last position's gathered over the vocabulary,
    `_last_logits`), and the cache is this rank's part of them in
    `rules.cache_specs`' layout for S positions (`_cache_part`, one layer
    at a time), with its ``global`` sizes (module docstring)."""
    _check_sharded(model, hint)
    batch, hint = local_batch({"tokens": tokens, **(extras or {})}, hint)
    tokens = batch.pop("tokens")
    extras = batch or None
    cfg = model.cfg
    B, S = tokens.shape
    ctx = _context(model, extras, B, mode=mode, hint=hint)
    h = _embed(model, tokens, hint)
    cache: dict = {"groups": [], "shared": [], "pos": S}
    glob: dict = {"batch": hint.batch, "groups": [], "shared": []} if sharded(hint) else {}
    for kind, layers in model.groups():
        entries = []
        for p in layers:
            h, c, _ = blocks_mod.apply_block(kind, _at(p, hint), h, cfg, ctx=ctx, mode=mode,
                                             hint=hint)
            part, slots = _cache_part(kind, c, hint)
            entries.append(part)
        cache["groups"].append({name: torch.stack([c[name] for c in entries]) for name in entries[0]})
        del entries
        if glob:
            glob["groups"].append(slots)
        if cfg.shared_attn_every:
            h, c, _ = blocks_mod.apply_block("attn", _at(model.shared_block, hint), h, cfg,
                                             mode=mode, hint=hint)
            part, slots = _cache_part("attn", c, hint)
            cache["shared"].append(part)
            if glob:
                glob["shared"].append(slots)
    if glob:
        cache["global"] = glob
    return _last_logits(model, h, hint), cache


# cache entries that hold K / V heads (the tensor-parallel layout's are the rank's)
HEAD_ENTRIES = ("k", "v", "xk", "xv")


def _cache_part(kind: str, entry: dict, hint) -> tuple[dict, dict]:
    """A layer's prefill cache entry as the rank keeps it (`rules.cache_specs`
    for its global batch): each K / V, latent or context entry's rank's
    slice of the time axis (dimension 1) where the spec splits it, else the
    entry whole; every head either way.  Under the tensor-parallel layout
    the rank computed its heads for every position: one all-to-all trades
    them for every head of its slots (`_heads_to_time`), or the heads are
    gathered; the other layouts computed every head whole (the
    sequence-parallel K / V and MLA's latents gathered over the sequence),
    so the rank keeps its slice.  A recurrent state is whole, as
    `rules.cache_specs` keeps it: under the SSD heads' split
    (`rules.ssm_heads`) the ranks' parts of a Mamba2 state are gathered
    (`ssm.gather_state`).  -> (the rank's entry, the global slots of each
    of its time entries)."""
    if kind == "mamba" and getattr(hint, "ssm_heads", False):
        return ssm_mod.gather_state(entry, hint.cfg, hint.seq_group), {}
    if not sharded(hint) or kind in blocks_mod.STATE_KINDS:
        return entry, {}
    seq = hint.seq_group
    out, slots = {}, {}
    for name, t in entry.items():
        split = rules.time_split(hint.batch, t.shape[1], hint.mesh, hint.cfg)
        slots[name] = t.shape[1]
        if _layout(hint) == "tp" and name in HEAD_ENTRIES:
            t = _heads_to_time(t, seq) if split else comm.all_gather(t, 2, seq)
        elif split:
            t = comm.slice_dim(t, 1, seq)
        out[name] = t
    return out, slots


def _heads_to_time(t: torch.Tensor, group) -> torch.Tensor:
    """(B, T, G / m, hd), the rank's heads at every slot, -> (B, T / m, G,
    hd), every head at the rank's slots: one all-to-all over `group`."""
    m = comm.group_size(group)
    B, T, g, hd = t.shape
    x = t.reshape(B, m, T // m, g, hd).transpose(0, 1)  # chunk j: slot block j
    y = comm.all_to_all(x, group)  # chunk j: rank j's heads of this rank's slots
    return y.permute(1, 2, 0, 3, 4).reshape(B, T // m, m * g, hd)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def ring_positions(pos: int, cache_len: int, *, device=None):
    """Absolute position held by each ring-buffer slot after writing `pos`.

    slot(i) holds the largest position p <= pos with p % cache_len == i.
    Slots with p > pos have not been written this lap: they hold
    p - cache_len (valid only if >= 0).  Also right for a full cache
    (cache_len >= S).
    """
    i = torch.arange(cache_len, device=device)
    lap = pos - ((pos - i) % cache_len)
    valid = lap >= 0
    kv_pos = torch.where(valid, lap, 2**30)
    return kv_pos, valid


def decode_step(model: LM, tokens: torch.Tensor, cache: dict, *, hint=None):
    """tokens (B, 1): append one token at absolute position ``cache["pos"]``
    -> (logits (B, V), cache).  The cache's tensors are written in place;
    the returned dict holds them and ``pos + 1``.  With a sharded `hint`,
    the tokens and the cache are this rank's rows and its part of each
    entry (`init_cache(mesh=)`, `prefill`'s), the work split over the model
    axis as `rules.decode_layout` says (module docstring)."""
    _check_sharded(model, hint)
    cfg = model.cfg
    pos = cache["pos"]
    glob = cache.get("global")
    if sharded(hint):
        if glob is None:
            raise ValueError("a sharded decode needs a cache of init_cache(mesh=) or prefill(hint=)")
        hint = hint.for_decode(glob["batch"])
    dev = tokens.device
    h = _embed(model, tokens, hint)
    for gi, ((kind, layers), gcache) in enumerate(zip(model.groups(), cache["groups"])):
        gglob = glob["groups"][gi] if glob else None
        cache_len = _group_cache_len(kind, gcache, gglob)
        kv = (_slot_view(pos, cache_len, _time_len(kind, gcache), hint, dev) if cache_len
              else dict(kv_pos=None, kv_valid=None))
        ctx = blocks_mod.CONTEXT_ENTRIES.get(kind, ())
        ctx_split = bool(ctx) and gglob is not None and gcache[ctx[0]].shape[2] != gglob[ctx[0]]
        for li, p in enumerate(layers):
            c = {name: t[li] for name, t in gcache.items()}
            h, _ = blocks_mod.apply_block_decode(
                kind, _at(p, hint), h, cfg, cache=c, pos=pos, hint=hint, ctx_split=ctx_split, **kv)
        if cfg.shared_attn_every:
            sc = cache["shared"][gi]
            total = glob["shared"][gi]["k"] if glob else sc["k"].shape[1]
            h, _ = blocks_mod.apply_block_decode(
                "attn", _at(model.shared_block, hint), h, cfg, cache=sc, pos=pos, hint=hint,
                **_slot_view(pos, total, sc["k"].shape[1], hint, dev),
            )
    logits = _head(model, h, hint)
    if getattr(hint, "vocab_parallel", False):
        logits = comm.all_gather(logits, 2, hint.seq_group)
    return logits[:, 0, :], dict(cache, pos=pos + 1)


def _slot_view(pos: int, total: int, local: int, hint, device) -> dict:
    """The ring positions (`ring_positions`) of the slots a rank's cache
    holds: `local` of `total` slots; when fewer, its block of them on the
    model axis (`rules.cache_specs`' contiguous split) -> ``kv_pos``,
    ``kv_valid`` and ``slots`` ((first, total) or None) for
    `blocks.apply_block_decode`."""
    kv_pos, kv_valid = ring_positions(pos, total, device=device)
    if local == total:
        return dict(kv_pos=kv_pos, kv_valid=kv_valid, slots=None)
    first = hint.model_rank * local
    return dict(kv_pos=kv_pos[first:first + local], kv_valid=kv_valid[first:first + local],
                slots=(first, total))


def _time_len(kind: str, gcache) -> int:
    """Slots a run's self-attention or MLA cache holds here."""
    return gcache["ckv" if kind in blocks_mod.MLA_KINDS else "k"].shape[2]


def _group_cache_len(kind: str, gcache, glob: dict | None = None) -> int | None:
    """Ring slots of a run's cache (its global count: `glob`, the run's
    ``global`` slots on a mesh); None for a state kind (no time axis) and
    for ``xattn`` (its slots are the context's, which decode reads whole)."""
    blocks_mod.check_kind(kind)
    if kind in blocks_mod.STATE_KINDS or kind == "xattn":
        return None
    name = "ckv" if kind in blocks_mod.MLA_KINDS else "k"
    return glob[name] if glob else gcache[name].shape[2]  # (L, B, T, ...)


# ---------------------------------------------------------------------------
# Cache init (for the serving engine)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, cache_len: int, *, ctx_len: int | None = None,
               device=None, mesh=None) -> dict:
    """Zero cache in the weights' dtype for `cache_len` positions on `device`
    (None = "cuda"; "meta" for the dry run, as `LM`): attention layers keep
    a ring of `cfg.window` slots when the arch has a window, MLA layers the
    full length, each application of the shared block a ring of
    ``min(cache_len, SHARED_ATTN_SLOTS)`` slots, the state kinds their f32
    state, and the context's K / V `ctx_len` rows (`blocks.init_block_cache`;
    as JAX's).  With `mesh`, `batch` is the global batch and the cache this
    rank's part of it, each entry as `rules.cache_specs` lays it out (the
    rows over the batch axes, the time axis over "model"), with its
    ``global`` sizes (module docstring)."""
    if mesh is not None:
        whole = init_cache(cfg, batch, cache_len, ctx_len=ctx_len, device="meta")
        specs = rules.cache_specs(whole, mesh, cfg)
        dev = _model_device(device)

        def part(t, spec):
            shape = rules.local_part(t, mesh, rules.placements(spec, mesh)).shape
            return torch.zeros(shape, dtype=t.dtype, device=dev)

        def time_slots(entry: dict, axis: int) -> dict:
            return {n: t.shape[axis] for n, t in entry.items() if n in rules.CACHE_TIME_ENTRIES}

        return {
            "groups": [{n: part(t, specs["groups"][i][n]) for n, t in g.items()}
                       for i, g in enumerate(whole["groups"])],
            "shared": [{n: part(t, specs["shared"][i][n]) for n, t in g.items()}
                       for i, g in enumerate(whole["shared"])],
            "pos": 0,
            "global": {"batch": batch,
                       "groups": [time_slots(g, 2) for g in whole["groups"]],
                       "shared": [time_slots(g, 1) for g in whole["shared"]]},
        }
    dev = _model_device(device)
    dtype = cfg.param_dtype
    window_len = min(cache_len, cfg.window) if cfg.window else cache_len
    cache: dict = {"groups": [], "shared": [], "pos": 0}
    for kind, count in cfg.blocks:
        clen = cache_len if kind in blocks_mod.MLA_KINDS else window_len
        one = blocks_mod.init_block_cache(kind, cfg, batch, clen, dtype, ctx_len=ctx_len,
                                          device=dev)
        cache["groups"].append(
            {name: t.new_empty((count, *t.shape)).copy_(t) for name, t in one.items()}
        )
    if cfg.shared_attn_every:
        shared_len = min(cache_len, SHARED_ATTN_SLOTS)
        cache["shared"] = [
            blocks_mod.init_block_cache("attn", cfg, batch, shared_len, dtype, device=dev)
            for _ in cfg.blocks
        ]
    return cache
