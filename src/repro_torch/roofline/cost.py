"""The cost of a traced step (the counterpart of `repro.roofline.hlo_cost`).

JAX's walker reads partitioned HLO.  The port has none: it runs eagerly,
so `CostMode`, a `TorchDispatchMode`, sees every ATen op of the step as it
runs, on the meta device in the dry run (`launch.dryrun`) or on the card,
and counts with JAX's conventions, a rank's own:

  flops        matmul-like ops by `torch.utils.flop_counter`'s formulas
               (2 x MACs; also apart, ``matmul_flops``); every other op that computes adds its result's
               element count (hlo_cost.py:10-11); views, reshapes, copies,
               casts, gathers / scatters, selects, compares, reductions,
               sorts, constants and random draws add nothing (its
               ``_ZERO_FLOP``).
  hbm_bytes    inputs plus outputs of every op that is not a view (an
               eager op is a kernel boundary, so this is the port's own
               count: above JAX's post-fusion one), plus each collective's
               result, as JAX counts it.
  score_bytes  the bytes of attention-score-shaped tensors among those
               inputs and outputs (JAX's ``_is_score``: at least 3-D, both
               trailing dims >= 1024), traffic a fused attention would not
               make.
  link_bytes   each collective `sharding.comm` issues, by JAX's ring model
               (`collectives`), by kind and by fabric.
  by_kernel    each hand-written kernel's calls, as its wrapper reports
               them (`kernels.counters.record`: the function's operations
               and bytes), added to flops and hbm_bytes: the dispatcher does
               not see a launch.

It also tracks the storages alive: the arguments' (`hold`) and each op's
new outputs', each until it is freed, and keeps the peak (bytes, as the
caching allocator would hold them at best).
"""

from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import counters
from ..sharding import comm
from . import collectives as coll

aten = torch.ops.aten

# collectives are counted where `sharding.comm` issues them
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# ops that move no bytes: allocations without a write, and reshapes that
# alias their input without a view annotation
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten.lift_fresh, aten.set_, aten.resize_,
}

# JAX's _ZERO_FLOP (hlo_cost.py:178) in ATen: data movement, casts, gathers
# and scatters, selects and compares, constants, iota, random draws, sorts
_ZERO_FLOP = _NO_TRAFFIC | {
    aten._to_copy, aten.copy_, aten.clone, aten._copy_from, aten.cat, aten.stack,
    aten.constant_pad_nd, aten.flip, aten.roll, aten.repeat, aten.repeat_interleave,
    aten.index, aten._unsafe_index, aten.index_select, aten.gather, aten.take,
    aten.embedding, aten.embedding_dense_backward, aten.scatter, aten.scatter_,
    aten.scatter_add, aten.scatter_add_, aten.scatter_reduce, aten.index_put,
    aten.index_put_, aten._index_put_impl_, aten.index_add, aten.index_add_,
    aten.index_copy, aten.index_copy_, aten.index_fill, aten.index_fill_,
    aten.slice_scatter, aten.select_scatter, aten.diagonal_scatter, aten.as_strided_scatter,
    aten.masked_scatter, aten.where, aten.masked_fill, aten.masked_fill_, aten.tril,
    aten.triu, aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge, aten.isnan,
    aten.logical_not, aten.arange, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like,
    aten.full, aten.full_like, aten.fill, aten.fill_, aten.zero_, aten.scalar_tensor,
    aten.new_zeros, aten.new_ones, aten.new_full, aten.rand, aten.randn, aten.randint,
    aten.rand_like, aten.randn_like, aten.normal, aten.normal_, aten.uniform_,
    aten.bernoulli, aten.bernoulli_, aten.random_, aten.sort, aten.argsort, aten.topk,
    aten._local_scalar_dense,
}

# reductions: no flops when the result is smaller than the input (JAX's
# ``reduce``); aten.max / aten.min with a second tensor are elementwise
_REDUCE = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.argmax, aten.argmin,
    aten.any, aten.all, aten.prod, aten.logsumexp, aten.var, aten.std, aten.var_mean,
    aten.std_mean, aten.linalg_vector_norm, aten.norm,
}


def _tensors(tree) -> list:
    """The tensors of `tree`, a DTensor as its local part: what the rank
    holds and moves (an op on a DTensor, such as the autograd engine's on a
    parameter's gradient, reaches the mode whole, and its wrapper's storage
    would count the global shape's bytes)."""
    from torch.distributed.tensor import DTensor

    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def is_score(t: torch.Tensor) -> bool:
    """JAX's `_is_score`: at least 3-D with both trailing dims >= 1024."""
    return t.ndim >= 3 and t.shape[-1] >= 1024 and t.shape[-2] >= 1024


def op_flops(func, args, kwargs, out) -> float:
    """The operations of one ATen op by the conventions above."""
    packet = func.overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if packet in _ZERO_FLOP:
        return 0.0
    outs = _tensors(out)
    if packet in _REDUCE:
        biggest = max((t.numel() for t in _tensors((args, kwargs))), default=0)
        if sum(t.numel() for t in outs) < biggest:
            return 0.0
    return float(sum(t.numel() for t in outs))


def storages(tree) -> list:
    """The distinct storages of the tensors in `tree` (a DTensor's local
    part; an `nn.Module`'s parameters and buffers)."""
    from torch.distributed.tensor import DTensor

    seen = {}
    for x in tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)):
        ts = list(x.parameters()) + list(x.buffers()) if isinstance(x, torch.nn.Module) else [x]
        for t in ts:
            if isinstance(t, DTensor):
                with torch.no_grad():
                    t = t.to_local()
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[id(st)] = st
    return list(seen.values())


class CostMode(TorchDispatchMode):
    """Counts the cost of everything run inside it (module docstring).
    ``hold(tree)`` first registers the arguments' storages.  `summary`,
    `collective_summary` and `memory` read the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.hbm_bytes = 0.0
        self.score_bytes = 0.0
        self.n_ops = 0
        self.by_op = defaultdict(lambda: [0, 0.0, 0.0])  # name -> [calls, flops, bytes]
        self.by_kernel: dict[str, dict] = {}
        self.records: list = []  # (kind, result bytes, group ranks) a collective
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakSet()
        self._depth = 0

    # -- the recorders' ends -------------------------------------------------

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.by_kernel.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def _collective(self, kind: str, nbytes: int, ranks: tuple) -> None:
        self.records.append((kind, nbytes, ranks))
        self.hbm_bytes += nbytes

    def __enter__(self):
        if not self._depth:  # re-entered to decompose a composite op
            counters.RECORDERS.append(self._kernel)
            comm.RECORDERS.append(self._collective)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            counters.RECORDERS.remove(self._kernel)
            comm.RECORDERS.remove(self._collective)
        return super().__exit__(*exc)

    # -- memory ----------------------------------------------------------------

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, st) -> bool:
        if st in self._seen:
            return False
        n = st.nbytes()
        self._seen.add(st)
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return True

    def hold(self, tree) -> int:
        """Register the storages of `tree` (the step's arguments) as alive
        from the start -> their bytes, added to `argument_bytes`."""
        n = 0
        for st in storages(tree):
            if self._track(st):
                n += st.nbytes()
        self.argument_bytes += n
        return n

    # -- the ops -----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry:
            # a composite op (`matmul`, `einsum`: under inference mode they
            # reach the mode whole) counts as the ops it is made of, as with
            # grad enabled
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace in _COMM_NAMESPACES:
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t.untyped_storage())
        if func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        ins = _tensors((args, kwargs))
        fl = op_flops(func, args, kwargs, out)
        if func.overloadpacket in flop_registry:
            self.matmul_flops += fl
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.flops += fl
        self.hbm_bytes += nb
        self.score_bytes += sum(_nbytes(t) for t in ins + outs if is_score(t))
        self.n_ops += 1
        row = self.by_op[str(func.overloadpacket)]
        row[0] += 1
        row[1] += fl
        row[2] += nb
        return out

    # -- reading -------------------------------------------------------------------

    def top_costs(self, metric: str = "hbm_bytes", n: int = 20) -> list[dict]:
        """The ATen ops with the largest total `metric` ("flops" or
        "hbm_bytes"), as `hlo_cost.top_costs` lists its HLO ops."""
        rows = [{"op": name, "calls": c, "flops": f, "hbm_bytes": b}
                for name, (c, f, b) in self.by_op.items()]
        return sorted(rows, key=lambda r: -r[metric])[:n]

    def collective_summary(self) -> dict:
        return coll.parse_collectives(self.records)

    def summary(self, top: int = 10) -> dict:
        """The record's ``cost``: totals, link traffic by kind and fabric,
        each kernel's calls and the top ops by flops and by bytes."""
        c = self.collective_summary()
        return {
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "hbm_bytes": self.hbm_bytes,
            "score_bytes": self.score_bytes,
            "link_bytes": c["link_bytes"],
            "link_by_fabric": c["link_by_fabric"],
            "coll_by_kind": c["bytes_by_kind"],
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
            "n_ops": self.n_ops,
            "top_flops": self.top_costs("flops", top),
            "top_bytes": self.top_costs("hbm_bytes", top),
        }

    def memory(self) -> dict:
        """Bytes: the arguments', and the peak of all storages alive."""
        return {"argument_bytes": self.argument_bytes, "peak_bytes": self.peak}
