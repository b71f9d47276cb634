"""Sharding rules (the counterpart of `repro.sharding.rules`): the LM
stack's parameter, batch and cache specs and activation hints, and the CV
batch rules of the sharded serve.

Mesh axes: ("pod", "data", "model") multi-pod or ("data", "model") single-pod.
  data  DP (batch); also the FSDP storage axis of the weights, and the
        expert-parallel axis of the MoE expert stacks.
  model TP: attention heads, FFN hidden, vocab; the sequence axis of the
        MoE layer's all-to-all path.
  pod   extra DP.

The rules are JAX's, line for line: an axis is used on a dimension only
when it divides it (`_maybe`).  They read nothing of a mesh but its axis
names and sizes, so a `MeshShape` describes a mesh without processes.  A
spec is a `PartitionSpec`: per dimension an axis name, a tuple of names or
None, as JAX's; `placements` turns it into DTensor placements over a
`DeviceMesh` (`launch.mesh.make_mesh`).

What the port stores and computes (`models.lm.shard_model`): each parameter
is a DTensor with the placements of `param_specs`, JAX's memory layout;
each rank computes its batch shard (`batch_specs`, `shard_batch`).  The
port's activations are plain local tensors, so `constrain` acts on
DTensors only; the layouts JAX's hints ask GSPMD for are computed by the
layers themselves, as `model_layout` reads `make_hint`'s table for a call
over `seq_len` positions:

  "tp"  q and KV heads both divide 16 (JAX's `tp_attn`) and the model
        axis: the hidden states split over the sequence between layers
        (``"act"``); attention over the rank's heads and the MLP over its
        slice of the FFN hidden (``"heads_q"``, ``"heads_kv"``, ``"ffn"``),
        each on the sequence gathered, its row-parallel output
        reduce-scattered back to the sequence slices (Megatron-SP);
  "sp"  the rest: ``"act"`` as above, attention queries, FFN and norms on
        the rank's slice of the sequence, K and V gathered over it, every
        weight gathered whole;
  None  one rank on the model axis, the batch over it (``dp_over_model``),
        or a sequence the axis does not divide: every rank of the model axis
        computes its rows whole, with every weight gathered.

A decode step (`decode_layout`) holds its rows whole on every rank of the
model axis, as JAX's does, and splits their work as JAX lays it out: the
cache's time axis over "model" (`cache_specs`: each rank attends over its
slots and the softmax is merged over the axis, split-K), and under "tp"
the heads and the FFN hidden too (their row-parallel products summed over
the axis); under "splitk" the weights are read whole.

Under "tp" and "sp" the embedding, logits and loss are vocab-parallel
(``"logits"``) when the vocabulary divides the axis (`vocab_parallel`).
`gather_axes` gives the mesh axes over which a leaf is gathered at use:
a tensor-parallel leaf keeps its "model" shard.  The MoE layer takes JAX's
all-to-all path on the sequence slices.  The Mamba2 mixer takes JAX's
``"ssm_heads"`` hint where the SSD heads divide the axis (`Hint.ssm_heads`):
each rank computes its heads on the gathered sequence and reads
``out_proj`` as its rows (row-parallel, `SSM_HEADS_LEAVES`); elsewhere, and
the xLSTM cells always, a recurrent mixer gathers the sequence and computes
it whole on every rank of the model axis.  In decode the MoE experts run
where they lie (expert-parallel) and a recurrent state stays whole, as in
JAX's `cache_specs`.

The optimizer state lies as JAX's dry run lowers it (`opt_state_specs`):
ZeRO-1 (`zero1`) adds "model", and "pod" on a multi-pod mesh, to a state
tensor whose parameter does not use that axis.  Such a spec may name a
dimension's axes in another order than the mesh's (("model", "pod")), which
DTensor placements cannot say; `spec_part` gives a rank's block of any
spec in JAX's order, the first axis major, and `NamedSharding.wrap` holds
it as a DTensor where the orders agree, else as a `SpecPart`.

The CV serving path shards one thing: the image-batch axis of a bucket
batch, and of everything the pipeline derives from it (descriptors,
validity masks and predictions all keep the batch axis leading).  Shards
are contiguous slices of that axis.  JAX's `cv_batch_spec`,
`cv_batch_sharding` and `cv_out_specs` build layouts for `shard_map`: the
port's dispatcher places each slice on its device itself, so they are not
ported.
"""

from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch


def cv_data_devices(mesh) -> list:
    """The devices along the mesh's "data" axis: the fault domains of the
    sharded CV dispatch, in shard order."""
    if "data" not in mesh.axis_names:
        raise ValueError(
            f"cv_data_devices: mesh has no 'data' axis (axes: "
            f"{mesh.axis_names}) — build one with launch.mesh.make_cv_mesh")
    return list(mesh.devices)


def cv_batch_split(batch: np.ndarray, n: int) -> tuple[list, int]:
    """Split a batch into `n` contiguous shards of equal size -> (shards,
    rows a shard).  The last row is repeated until the batch divides `n`;
    those padding rows are dropped again on merge."""
    pad = (-batch.shape[0]) % n
    if pad:
        batch = np.concatenate([batch, batch[-1:].repeat(pad, axis=0)])
    per = batch.shape[0] // n
    return [batch[i * per:(i + 1) * per] for i in range(n)], per


# ---------------------------------------------------------------------------
# Specs and meshes
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """JAX's `PartitionSpec`: per dimension an axis name, a tuple of axis
    names (the dimension split over their product, the first major) or
    None (not split); dimensions past its length are not split.  A tuple
    of one name is that name, as in JAX."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or processes: what
    the rules read of a `DeviceMesh` (``mesh_dim_names``, ``shape``)."""

    shape: tuple
    mesh_dim_names: tuple


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh, cfg=None) -> tuple:
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    # small archs with nothing to tensor-parallelize (xlstm-125m) run pure
    # DP: the batch is split over the model axis as well
    if cfg is not None and getattr(cfg, "dp_over_model", False):
        dp = dp + ("model",)
    return dp


def _maybe(axis, dim: int, sizes: dict[str, int]):
    """`axis` (a name or a tuple) on a dimension only if it divides it."""
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    total = 1
    for a in axes:
        total *= sizes.get(a, 1)
    if total > 1 and dim % total == 0:
        return axis
    # shrink a tuple from the left (("data", "model") -> "model")
    if not isinstance(axis, str) and len(axes) > 1:
        return _maybe(axes[-1], dim, sizes)
    return None


def prune(shape, spec: PartitionSpec, mesh) -> PartitionSpec:
    """`spec` for a tensor of `shape`, each axis that does not divide its
    dimension dropped (`constrain`'s rule)."""
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(spec) + (None,) * (len(shape) - len(spec))
    return P(*[_maybe(ax, dim, sizes) for dim, ax in zip(shape, axes)])


def constrain(x, spec: PartitionSpec, mesh):
    """JAX's `with_sharding_constraint` with the indivisible axes pruned:
    a DTensor `x` is redistributed to the pruned spec; a plain tensor (every
    activation of the port, a rank's local part) is returned as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(prune(x.shape, spec, mesh), x.device_mesh))


# ---------------------------------------------------------------------------
# Parameter specs (by JAX's parameter path)
# ---------------------------------------------------------------------------


def _leaf_spec(path: tuple, shape: tuple, cfg, sizes) -> PartitionSpec:
    name = path[-1]
    fsdp = "data" if cfg.fsdp else None
    tp_attn = cfg.heads_shardable and cfg.kv_heads_shardable
    in_mixer = "mixer" in path or "cell" in path
    in_moe_stack = len(shape) == 3 and name in ("w_gate", "w_up", "w_down")

    def spec(*axes):
        return P(*[_maybe(a, d, sizes) for a, d in zip(axes, shape)])

    if name == "embed":
        return spec("model", fsdp)  # vocab-sharded
    if name == "lm_head":
        return spec(fsdp, "model")
    if in_moe_stack:  # (E, D, F) / (E, F, D)
        # pure EP: experts over data x model jointly when divisible, else "model"
        return spec(("data", "model"), None, None)
    if name == "router":
        return spec(None, None)
    if name in ("router_bias", "b_i", "b_f", "A_log", "D", "dt_bias", "b_gates",
                "gate_attn", "gate_mlp"):
        return P(*([None] * len(shape)))
    if in_mixer:
        # Mamba2 / xLSTM internals: the fused in / up projections keep their
        # output dimension whole; the output projection is row-parallel
        if name in ("in_proj", "w_up"):
            return spec(fsdp, None)
        if name in ("out_proj", "w_down"):
            return spec("model", fsdp)
        if name in ("w_q", "w_k", "w_v"):
            return spec(None, None)
        if name in ("conv_w", "conv_b", "w_if", "r_gates"):
            return P(*([None] * len(shape)))
    # attention projections: TP over heads only when q and kv heads both
    # divide the model axis
    if name == "w_q":
        return spec(fsdp, "model") if tp_attn else spec(fsdp, None)
    if name in ("w_k", "w_v"):
        return spec(fsdp, "model") if tp_attn else spec(fsdp, None)
    if name == "w_o":
        return spec("model", fsdp) if tp_attn else spec(fsdp, None)
    if name == "b_q":
        return spec("model" if tp_attn else None)
    if name in ("b_k", "b_v"):
        return spec("model" if tp_attn else None)
    # MLA
    if name in ("w_dq", "w_dkv", "w_kr"):
        return spec(fsdp, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return spec(None, "model" if tp_attn else None)
    # dense MLP: TP over F when attention is TP'd, else FSDP-stored only
    if name in ("w_gate", "w_up"):
        return spec(fsdp, "model") if tp_attn else spec(fsdp, None)
    if name == "w_down":
        return spec("model", fsdp) if tp_attn else spec(fsdp, None)
    if name in ("b_up",):
        return spec("model" if tp_attn else None)
    if name in ("b_down",):
        return spec(None)
    # norms and everything else: replicated
    return P(*([None] * len(shape)))


def _leaf_shape(leaf) -> tuple:
    """A `models.lm.Leaf`'s shape in JAX's tree (a stacked leaf has the
    layer axis first)."""
    p = leaf.params[0]
    return (len(leaf.params), *p.shape) if leaf.stacked else tuple(p.shape)


def param_specs(leaves, cfg, mesh) -> dict[str, PartitionSpec]:
    """JAX's `param_specs` over `models.lm.param_leaves`: name -> spec of
    the leaf in JAX's tree.  The names are JAX's paths (``groups.0.attn.w_q``)
    and a stacked leaf's spec has None for its layer axis, which the rule
    skips, as JAX's (a layer's parameter takes the rest of the spec)."""
    sizes = mesh_axis_sizes(mesh)
    out = {}
    for leaf in leaves:
        names = tuple(leaf.name.split("."))
        shape = _leaf_shape(leaf)
        stacked = "groups" in names
        eff = shape[1:] if stacked and shape else shape
        spec = _leaf_spec(names, eff, cfg, sizes)
        out[leaf.name] = P(None, *spec) if stacked else spec
    return out


# ---------------------------------------------------------------------------
# Activation hints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hint:
    """`make_hint`'s callable: ``hint(x, name)`` constrains `x` to the
    table's spec for `name` (`constrain`), and carries the `mesh` and `cfg`
    that the layers read (the MoE all-to-all plan).  `batch` is the global
    batch size of the call running under it, which a layer, seeing only
    its rank's part, cannot know, and `layout` the call's `model_layout`
    (`models.lm` sets both; `at` gives the layout of another length)."""

    mesh: object
    cfg: object
    table: dict
    batch: int | None = None
    layout: str | None = None
    decode: bool = False

    def __call__(self, x, name: str = "act"):
        spec = self.table.get(name)
        if spec is None or x.ndim < len(spec):
            return x
        return constrain(x, spec, self.mesh)

    def at(self, seq_len: int) -> "Hint":
        """This hint for a call over `seq_len` positions."""
        return dataclasses.replace(self, layout=model_layout(self.cfg, self.mesh, seq_len))

    def for_decode(self, batch: int) -> "Hint":
        """This hint for a decode step of a global batch of `batch` rows
        (`decode_layout`; `decode` set: the rows are whole on every rank of
        the model axis)."""
        return dataclasses.replace(self, layout=decode_layout(self.cfg, self.mesh), batch=batch,
                                   decode=True)

    @property
    def model_size(self) -> int:
        return mesh_axis_sizes(self.mesh).get("model", 1)

    @property
    def seq_group(self):
        """The process group of this rank's model axis (`sharding.comm`)."""
        from . import comm

        return comm.axes_group(self.mesh, ("model",))

    @property
    def model_rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.seq_group)

    @property
    def vocab_parallel(self) -> bool:
        return self.layout is not None and vocab_parallel(self.cfg, self.mesh)

    @property
    def ssm_heads(self) -> bool:
        """Does the Mamba2 mixer split its SSD heads over the model axis in
        this call (`ssm_heads`; never in decode, whose state is whole)?"""
        return not self.decode and ssm_heads(self.cfg, self.mesh, self.layout)


def tp_dims(cfg) -> tuple:
    """The dimensions that the tensor-parallel layout splits over the model
    axis: the q and KV heads, the FFN hidden of the dense MLP and of the MoE
    layer's shared experts."""
    dims = [cfg.n_heads, cfg.n_kv_heads]
    if cfg.d_ff:
        dims.append(cfg.d_ff)
    if cfg.moe is not None and cfg.moe.n_shared:
        dims.append(cfg.moe.d_ff_shared * cfg.moe.n_shared)
    return tuple(dims)


def model_layout(cfg, mesh, seq_len: int) -> str | None:
    """How the model axis splits a call over `seq_len` positions: "tp",
    "sp" or None (module docstring).  "tp" is JAX's `tp_attn` (q and KV
    heads both divide 16, `make_hint`'s ``"heads_q"`` over heads) where the
    axis divides every dimension it splits (`tp_dims`: else `_maybe` would
    have left a weight whole)."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    if m == 1 or "model" in dp_axes(mesh, cfg) or seq_len % m:
        return None
    tp = cfg.heads_shardable and cfg.kv_heads_shardable
    return "tp" if tp and all(d % m == 0 for d in tp_dims(cfg)) else "sp"


def decode_layout(cfg, mesh) -> str | None:
    """How the model axis splits a decode step: "tp" where `model_layout`'s
    head test holds (the heads and FFN hidden over "model", as the weights
    lie); else "splitk", the weights read whole over "model", as JAX stores
    them for the grouped archs; None for one model rank or the batch over
    it (``dp_over_model``).  Under either the cache entries that
    `cache_specs` splits over time are attended split-K."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    if m == 1 or "model" in dp_axes(mesh, cfg):
        return None
    tp = cfg.heads_shardable and cfg.kv_heads_shardable
    return "tp" if tp and all(d % m == 0 for d in tp_dims(cfg)) else "splitk"


def ssm_heads(cfg, mesh, layout: str | None) -> bool:
    """JAX's ``"ssm_heads"`` split of the Mamba2 mixer: its SSD heads over
    "model" (``P(dp, None, "model", None)`` on (B, S, H, P)) in a call of
    `layout` (`model_layout`: not None, so the model axis has more than one
    rank and is no batch axis) where the heads divide the axis."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    return layout is not None and cfg.ssm is not None and cfg.ssm.n_heads % m == 0


def vocab_parallel(cfg, mesh) -> bool:
    """Are the embedding and the head split over the vocabulary on the
    model axis (``embed``'s spec: when the axis divides it)?"""
    m = mesh_axis_sizes(mesh).get("model", 1)
    return m > 1 and cfg.vocab_size % m == 0


# the leaves a tensor-parallel layer reads where they lie on the model axis
# (the dense ones: the MoE expert stacks have three dimensions)
TP_LEAVES = frozenset({"w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v", "w_gate", "w_up",
                       "w_down", "b_up", "w_uq", "w_uk", "w_uv"})
VOCAB_LEAVES = frozenset({"embed", "lm_head"})
# the recurrent sub-modules: computed whole on every rank of the model axis,
# but the Mamba2 mixer under the SSD heads' split, which reads its
# row-parallel output projection where it lies
WHOLE_MODULES = frozenset({"mixer", "cell"})
SSM_HEADS_LEAVES = frozenset({"out_proj"})


def local_leaves(hint) -> frozenset:
    """The leaf names a layer reads with their model shard kept, under
    `hint`'s layout."""
    if hint is None or getattr(hint, "layout", None) is None:
        return frozenset()
    names = TP_LEAVES if hint.layout == "tp" else frozenset()
    if hint.vocab_parallel:
        names = names | VOCAB_LEAVES
    return names | SSM_HEADS_LEAVES if hint.ssm_heads else names


def module_leaves(key: str, keep: frozenset) -> frozenset:
    """`keep` (`local_leaves`) as the sub-module `key` reads it: a recurrent
    one (`WHOLE_MODULES`) keeps only the SSD heads' leaves, the Mamba2
    mixer's, and only under their split."""
    if key not in WHOLE_MODULES:
        return keep
    return keep & SSM_HEADS_LEAVES if key == "mixer" else frozenset()


def gather_axes(mesh, name: str, ndim: int, keep: frozenset) -> tuple | None:
    """The mesh axes over which the leaf `name` (of `ndim` dimensions) is
    gathered at use: every axis but "model" for a leaf in `keep`
    (`local_leaves`), else all (None)."""
    if name in keep and ndim <= 2:
        return tuple(a for a in mesh.mesh_dim_names if a != "model")
    return None


def make_hint(mesh, cfg) -> Hint:
    """The activation hints of `cfg` on `mesh`: JAX's table."""
    dp = dp_axes(mesh, cfg)
    heads_ok = cfg.heads_shardable
    kv_ok = cfg.kv_heads_shardable
    ssm_heads_ok = (cfg.ssm is not None
                    and cfg.ssm.n_heads % mesh_axis_sizes(mesh).get("model", 1) == 0)
    if "model" in dp:  # pure-DP arch: "model" already taken by the batch
        table = {
            "act": P(dp, None, None),
            "heads_q": P(dp, None, None, None),
            "heads_kv": P(dp, None, None, None),
            "ffn": P(dp, None, None),
            "moe_dispatch": P(("data", "model"), None, None),
            "moe_ffn": P(("data", "model"), None, None),
            "moe_group": P(dp, None, None, None),
            "ssm_heads": P(dp, None, None, None),
            "logits": P(dp, None, None),
        }
    else:
        tp = heads_ok and kv_ok
        table = {
            "act": P(dp, "model", None),
            "heads_q": P(dp, None, "model", None) if tp else P(dp, "model", None, None),
            "heads_kv": P(dp, None, "model", None) if tp else P(dp, None, None, None),
            "ffn": P(dp, None, "model") if tp else P(dp, "model", None),
            "moe_dispatch": P(("data", "model"), None, None),
            "moe_ffn": P(("data", "model"), None, None),
            "moe_group": P(dp, "model", None, None),
            "ssm_heads": P(dp, None, "model", None) if ssm_heads_ok else P(dp, None, None, None),
            "logits": P(dp, None, "model"),
        }
    return Hint(mesh, cfg, table)


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state specs (JAX's dry run: `repro.launch.dryrun`)
# ---------------------------------------------------------------------------


def zero1(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """ZeRO-1: shard optimizer state over every mesh axis the parameter
    itself does not use ('model' for SP-FFN weights, 'pod' in multi-pod):
    each such axis on the first dimension it divides, alone on a dimension
    the spec leaves whole, else after the dimension's axis (JAX's
    `_zero1`)."""
    sizes = mesh_axis_sizes(mesh)
    fixed = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    used = {a for ax in fixed for a in spec_axes(ax)}
    for extra in ("model", "pod"):
        if extra not in sizes or extra in used:
            continue
        for i, (ax, d) in enumerate(zip(fixed, shape)):
            if ax is None and d % sizes[extra] == 0 and d > 1:
                fixed[i] = extra
                used.add(extra)
                break
            if isinstance(ax, str) and d % (sizes[ax] * sizes[extra]) == 0:
                fixed[i] = (ax, extra)
                used.add(extra)
                break
    return P(*fixed)


def factor_specs(spec: PartitionSpec, shape, mesh) -> dict:
    """Adafactor's state specs of a leaf of `shape` and param `spec`:
    ``vr`` the spec without its last axis and ``vc`` without its
    second-to-last, each under `zero1`, for a leaf of rank 2 and above;
    else ``v`` in the parameter's spec (JAX's `opt_state_specs`)."""
    axes = tuple(spec) + (None,) * (len(shape) - len(spec))
    if len(shape) >= 2:
        return {"vr": zero1(P(*axes[:-1]), shape[:-1], mesh),
                "vc": zero1(P(*axes[:-2], axes[-1]), shape[:-2] + shape[-1:], mesh)}
    return {"v": P(*axes)}


def opt_state_specs(leaves, pspecs: dict, mesh, optimizer: str) -> dict:
    """JAX's optimizer-state specs under ZeRO-1 (`zero1`) over
    `models.lm.param_leaves` and their `param_specs`: AdamW ``{"m": {leaf:
    spec}, "v": ..., "count": P()}``; Adafactor ``{"f": [one a leaf:
    `factor_specs`], "count": P()}``.  `train.step` stores the state so."""
    shapes = {lf.name: _leaf_shape(lf) for lf in leaves}
    if optimizer == "adamw":
        m = {lf.name: zero1(pspecs[lf.name], shapes[lf.name], mesh) for lf in leaves}
        return {"m": m, "v": dict(m), "count": P()}
    return {"f": [factor_specs(pspecs[lf.name], shapes[lf.name], mesh) for lf in leaves],
            "count": P()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch: dict, mesh, cfg=None) -> dict[str, PartitionSpec]:
    """Tokens, labels and context inputs: the leading (batch) dimension
    over the DP axes, when they divide it."""
    dp = dp_axes(mesh, cfg)
    sizes = mesh_axis_sizes(mesh)
    out = {}
    for k, t in batch.items():
        nd = len(t.shape)
        out[k] = P(_maybe(dp, t.shape[0], sizes), *([None] * (nd - 1))) if nd else P()
    return out


CACHE_TIME_ENTRIES = ("k", "v", "xk", "xv", "ckv", "kr", "ctx")


def _entry_spec(name: str, shape: tuple, dp: tuple, sizes: dict) -> PartitionSpec:
    """`cache_specs`' spec of one entry of `shape` (no layer axis)."""
    axes: list = [None] * len(shape)
    axes[0] = _maybe(dp, shape[0], sizes)
    model_free = "model" not in (axes[0] or ()) and axes[0] != "model"
    if name in CACHE_TIME_ENTRIES and len(shape) >= 2 and model_free:
        axes[1] = _maybe("model", shape[1], sizes)
    return P(*axes)


def cache_specs(cache: dict, mesh, cfg) -> dict:
    """Decode caches (`models.lm.init_cache`'s tree, JAX's layout): batch
    over DP, the time axis of the K / V and latent entries over "model"
    (split-K decode); a run's entries have the stacked layer axis first.
    The same tree with a spec at each tensor (``pos``: ``P()``)."""
    dp = dp_axes(mesh, cfg)
    sizes = mesh_axis_sizes(mesh)

    def one(name: str, shape: tuple, stacked: bool):
        eff = shape[1:] if stacked else shape
        if not eff:
            return P()
        spec = _entry_spec(name, eff, dp, sizes)
        return P(None, *spec) if stacked else spec

    def walk(node, stacked):
        if isinstance(node, dict):
            return {k: (walk(v, stacked) if isinstance(v, (dict, list))
                        else one(k, tuple(getattr(v, "shape", ())), stacked))
                    for k, v in node.items()}
        return [walk(v, stacked) for v in node]

    return {k: walk(v, k == "groups") if isinstance(v, (dict, list))
            else one(k, tuple(getattr(v, "shape", ())), False) for k, v in cache.items()}


def time_split(batch: int, slots: int, mesh, cfg) -> bool:
    """Does `cache_specs` split over "model" the time axis of a cache entry
    of `slots` slots for a global batch of `batch` rows?  Not where the
    axis does not divide the slots or the batch is over "model"."""
    spec = _entry_spec("k", (batch, slots), dp_axes(mesh, cfg), mesh_axis_sizes(mesh))
    return spec[1] == "model"


# ---------------------------------------------------------------------------
# DTensor placements and local parts
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh`: ``Shard(d)`` on each mesh
    dimension that splits tensor dimension d, ``Replicate()`` elsewhere.  A
    dimension split over a tuple of axes is split over them in the mesh's
    order, the first major, as in JAX; a tuple in another order raises
    `ValueError`."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dimension {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_axes(ax) -> tuple:
    """A spec entry's axis names, major first (None: none)."""
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def in_mesh_order(spec: PartitionSpec, mesh) -> bool:
    """Does every dimension of `spec` name its axes in the mesh's order, so
    that DTensor placements say its blocks (`placements`)?"""
    names = tuple(mesh.mesh_dim_names)
    return all(list(idx) == sorted(idx)
               for idx in ([names.index(a) for a in spec_axes(ax)] for ax in spec))


def spec_shape(shape, spec: PartitionSpec, mesh) -> tuple:
    """The shape of a rank's block of a tensor of `shape` under `spec`."""
    sizes = mesh_axis_sizes(mesh)
    axes = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in spec_axes(ax)) for d, ax in zip(shape, axes))


def spec_part(t: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `spec`, as JAX's
    `NamedSharding` places it (a view; no communication): a dimension over
    several axes is split over their product, the first named major,
    whatever the mesh's order.  In the mesh's order it is `local_part` of
    `placements`."""
    for d, ax in enumerate(spec):
        for a in spec_axes(ax):
            n = mesh.size(mesh.mesh_dim_names.index(a))
            if t.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(t.shape)} does not divide over {n} ranks")
            t = t.chunk(n, dim=d)[mesh.get_local_rank(a)]
    return t


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's `NamedSharding`: a mesh and a spec, or DTensor placements
    directly (`placements`)."""

    mesh: object
    spec: PartitionSpec | tuple

    @property
    def placements(self) -> tuple:
        if isinstance(self.spec, PartitionSpec):
            return placements(self.spec, self.mesh)
        return tuple(self.spec)

    def part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor `t`."""
        if isinstance(self.spec, PartitionSpec):
            return spec_part(t, self.mesh, self.spec)
        return local_part(t, self.mesh, self.spec)

    def wrap(self, local: torch.Tensor):
        """`local`, this rank's block, as a DTensor of these placements, or a
        `SpecPart` where the spec's order is not the mesh's."""
        from torch.distributed.tensor import DTensor

        if isinstance(self.spec, PartitionSpec) and not in_mesh_order(self.spec, self.mesh):
            return SpecPart(local, self)
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False)


class SpecPart(typing.NamedTuple):
    """A rank's block of a tensor under a spec whose order over the mesh
    DTensor placements cannot say (`NamedSharding.wrap`); `sharding.comm.
    spec_full` gathers it whole."""

    local: torch.Tensor
    sharding: NamedSharding


def local_part(t: torch.Tensor, mesh, placements_) -> torch.Tensor:
    """This rank's part of the full tensor `t` under `placements_` (a view;
    no communication: every rank holds `t`).  Several mesh dimensions on one
    tensor dimension split it in the mesh's order."""
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if t.shape[pl.dim] % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(t.shape)} does not divide "
                                 f"over {n} ranks")
            t = t.chunk(n, dim=pl.dim)[mesh.get_local_rank(i)]
    return t


def shard_tensor(t: torch.Tensor, mesh, placements_):
    """A DTensor holding this rank's part of the full tensor `t` (which
    every rank holds) under `placements_`: a copy when it is a strict part,
    so that `t` can be freed; `t` itself on a mesh of one rank."""
    from torch.distributed.tensor import DTensor

    part = local_part(t, mesh, placements_)
    part = part.clone(memory_format=torch.contiguous_format) if part.numel() < t.numel() else t
    return DTensor.from_local(part, mesh, placements_, run_check=False)


def shard_batch(batch: dict, mesh, cfg=None) -> dict:
    """This rank's part of a global batch (every rank holds it) under
    `batch_specs`."""
    specs = batch_specs(batch, mesh, cfg)
    return {k: local_part(t, mesh, placements(specs[k], mesh)) for k, t in batch.items()}


def batch_axes(n: int, mesh, cfg=None) -> tuple:
    """The mesh axes that split a batch of `n` rows (`batch_specs`' rule)."""
    ax = _maybe(dp_axes(mesh, cfg), n, mesh_axis_sizes(mesh))
    return () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))
