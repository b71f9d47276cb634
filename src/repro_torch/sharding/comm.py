"""The collectives of the sharded LM stack, each differentiable with its
adjoint as its backward.

A rank's backward pass computes its share of the gradient of the global
loss, and the true gradient of anything is the sum of the ranks' shares:
each rank differentiates ``loss / world_size``, where its loss is the mean
over its batch part (`train.step`), and every collective's backward is its
adjoint (all-gather <-> reduce-scatter, a slice <-> zero padding, an
all-to-all <-> the inverse all-to-all, a mean all-reduce <-> itself).  So
a parameter gathered at use (`gather_param`) gets, in its backward, its
gradient reduce-scattered over the mesh dimensions that split it and
summed over those that replicate it: the FSDP pattern, with JAX's
per-parameter specs (`sharding.rules.param_specs`), whether the ranks
along the model axis computed the same thing or each its part (a slice of
the sequence, a slice of the heads, the FFN hidden or the vocabulary).  A
tensor-parallel parameter is gathered over "data" only (``axes=``) and
keeps its "model" shard, whose gradient stays where it is.

The Megatron-style sequence parallelism of `models` (the hidden states
split over the sequence on the model axis between layers) takes three
more: the sequence all-gather (`gather_dim`, whose adjoint is a
reduce-scatter), the reduce-scatter of a row-parallel product's partial
sums back to the sequence slices (`scatter_dim`, whose adjoint is an
all-gather), and the vocab-parallel loss's sums over the model axis
(`sum_over`, an all-reduce whose adjoint is itself; `max_over` for the
detached row max, which takes no gradient).  A loss that the ranks of the
model axis compute together is the same number on each of them, so that
each differentiating ``loss / world_size`` counts it once over the mesh.
Decode runs under inference mode and takes the same sums and maxima for
its split-K softmax and its row-parallel products (`Over`), and
`all_gather` for the heads of a new token and the MoE's tokens.

Every function runs on `torch.distributed` groups: NCCL on the card, gloo
on the CPU, the fake backend in the dry run (`launch.mesh`).  A group of
one rank is skipped.  Every collective issued is reported to the active
cost recorders (`RECORDERS`, `roofline.cost`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

_GROUPS: dict = {}

# The active cost recorders (`roofline.cost.CostMode`): each collective below
# calls every one with (kind, bytes of its result, the ranks of its group),
# the kinds named as XLA's HLO names them.  With none active a collective
# pays one empty-list check.
RECORDERS: list = []


def _record(kind: str, out: torch.Tensor, group) -> None:
    if RECORDERS:
        ranks = tuple(dist.get_process_group_ranks(group))
        for r in RECORDERS:
            r(kind, out.numel() * out.element_size(), ranks)


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def axes_group(mesh, axes: tuple):
    """The process group over the ranks of `mesh` that differ only along
    `axes` (names, in the mesh's order; the first major), which every rank
    of the mesh makes together at its first call."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        ranks = mesh.mesh
        idx = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in idx]
        rows = ranks.permute(*rest, *idx).reshape(-1, math.prod(mesh.size(i) for i in idx))
        if rows.shape[0] == 1 and rows[0].tolist() == list(range(dist.get_world_size())):
            _GROUPS[key] = dist.group.WORLD
        else:
            _GROUPS[key], _ = dist.new_subgroups_by_enumeration(rows.tolist())
    return _GROUPS[key]


# ---------------------------------------------------------------------------
# The plain collectives
# ---------------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in rank order."""
    n = group_size(group)
    if n == 1:
        return x
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    _record("all-gather", out, group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along `dim` of the ranks' `x` summed."""
    n = group_size(group)
    if n == 1:
        return x
    chunks = torch.stack(x.chunk(n, dim=dim)).contiguous()
    out = chunks.new_empty(chunks.shape[1:])
    dist.reduce_scatter_tensor(out, chunks.reshape(-1, *chunks.shape[2:]), group=group)
    _record("reduce-scatter", out, group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The ranks' `x` reduced (in place; returned)."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=op, group=group)
        _record("all-reduce", x, group)
    return x


def full(local: torch.Tensor, mesh, placements, use=None) -> torch.Tensor:
    """The full tensor of which each rank holds `local` under `placements`
    (no autograd); with `use` (a bool a mesh dimension), gathered only over
    the dimensions it marks."""
    x = local
    for i in reversed(range(len(placements))):  # the minor mesh dimension first
        if placements[i].is_shard() and (use is None or use[i]):
            x = all_gather(x, placements[i].dim, mesh.get_group(i))
    return x


def spec_full(local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full tensor of which each rank holds `local` under the JAX spec
    `spec` (`sharding.rules.spec_part`: a dimension's axes the first major,
    whatever the mesh's order), no autograd: gathered over each dimension's
    axes, the minor first."""
    x = local
    for d, ax in enumerate(spec):
        for a in reversed((ax,) if isinstance(ax, str) else tuple(ax or ())):
            x = all_gather(x, d, mesh.get_group(a))
    return x


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """`x` of the rank `src` of `group` (its index there) written into every
    rank's `x`, in place (returned); reported as XLA's
    ``collective-broadcast``."""
    if group_size(group) > 1:
        buf = x if x.is_contiguous() else x.contiguous()
        dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
        if buf is not x:
            x.copy_(buf)
        _record("collective-broadcast", x, group)
    return x


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous() if n > 1 else x


# ---------------------------------------------------------------------------
# Differentiable forms
# ---------------------------------------------------------------------------


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements, use):
        ctx.mesh, ctx.placements, ctx.use = mesh, placements, use
        out = full(local, mesh, placements, use)
        return local.view_as(local) if out is local else out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for i, pl in enumerate(ctx.placements):
            if pl.is_shard():
                if ctx.use[i]:
                    g = reduce_scatter(g, pl.dim, ctx.mesh.get_group(i))
            elif ctx.mesh.size(i) > 1:
                g = all_reduce(g.clone(), ctx.mesh.get_group(i))
        return g, None, None, None


class _SumReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        # summed in place over the replicating dimensions, so copied first;
        # a part that no dimension replicates (an expert stack over every
        # axis) is passed on as it is, with no copy of its size
        reps = [i for i, pl in enumerate(ctx.placements)
                if not pl.is_shard() and ctx.mesh.size(i) > 1]
        g = g.contiguous()
        if reps:
            g = g.clone()
        for i in reps:
            all_reduce(g, ctx.mesh.get_group(i))
        return g, None, None


def _mesh_of_one(p) -> bool:
    return p.device_mesh.size() == 1


def gather_param(p, axes: tuple | None = None) -> torch.Tensor:
    """The full value of a DTensor parameter, as a plain tensor: gathered
    over the mesh dimensions that split it; in the backward, its gradient
    reduce-scattered back over them and summed over the others.  With
    `axes` (mesh axis names), gathered over those only: a shard over any
    other dimension stays this rank's, and so does its gradient."""
    if _mesh_of_one(p):
        return p.to_local()
    names = p.device_mesh.mesh_dim_names
    use = tuple(axes is None or n in axes for n in names)
    return _GatherParam.apply(p.to_local(), p.device_mesh, tuple(p.placements), use)


def local_param(p) -> torch.Tensor:
    """This rank's part of a DTensor parameter, as a plain tensor, used
    where it lies (the MoE experts of the all-to-all path); in the backward,
    its gradient summed over the mesh dimensions that replicate it."""
    if _mesh_of_one(p):
        return p.to_local()
    return _SumReplicas.apply(p.to_local(), p.device_mesh, tuple(p.placements))


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        return _own(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        full = g.new_zeros(ctx.shape)
        size = ctx.shape[ctx.dim] // n
        full.narrow(ctx.dim, dist.get_rank(ctx.group) * size, size).copy_(g)
        return full, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.group), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _record("all-to-all", out, group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group) / group_size(ctx.group), None


def slice_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of `x` (the same on every rank of `group`) along
    `dim`."""
    if group_size(group) == 1:
        return x
    return _Slice.apply(x, dim, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, dim, group)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along `dim` of the ranks' `x` summed (a row-parallel
    product's partial sums back to the sequence slices)."""
    if group_size(group) == 1:
        return x
    return _Scatter.apply(x, dim, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` summed, on every rank."""
    if group_size(group) == 1:
        return x
    return _Sum.apply(x, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x`, element-wise maximum, on every rank; no gradient."""
    x = x.detach()
    if group_size(group) == 1:
        return x
    return all_reduce(x.clone(), group, op=dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """`x` (n, ...) with n the group's size: chunk j to rank j; the result's
    chunk j came from rank j."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` averaged."""
    if group_size(group) == 1:
        return x
    return _Mean.apply(x, group)


class Over:
    """The merges of a computation split over the ranks of `group` (a
    split-K decode's softmax, `models.attention`): each rank's partial
    maximum or sum reduced to the group's, on every rank (`max_over`,
    `sum_over`).  Anything with these two methods stands in for it (a
    test's slices on one process)."""

    def __init__(self, group):
        self.group = group

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return sum_over(x, self.group)
