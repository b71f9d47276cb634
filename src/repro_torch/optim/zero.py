"""ZeRO-1 on a mesh: where each rank's part of the optimizer state lies
and which part of each parameter the rank updates.

JAX's dry run stores the optimizer state as `sharding.rules.opt_state_specs`
lays it out: a state tensor takes its parameter's spec (Adafactor's
factors the spec without the reduced axis) plus, by `rules.zero1`, the
mesh axes the parameter does not use ("model", and "pod" on a multi-pod
mesh), and the parameters come out in their own specs.  Each such extra
axis splits a dimension of the rank's part further: the dimension the
parameter leaves whole, or its block of a dimension the parameter splits
(JAX's ``(ax, extra)``: the parameter's axis major).  So a rank's state is a
block of its parameter's local part, cut by `Split`s.

Each rank updates the slice of its parameter's local part that
`rules.zero1` of the parameter's spec cuts (AdamW: the moments' block;
Adafactor: its factored leaves' too; an unfactored leaf's ``v`` lies in the
parameter's spec, so the whole local part), then the slices are gathered
over the extra axes to rebuild the local part (`ZeroLeaf.rebuild`), JAX's
out-sharding of the parameters.  A split of a stacked leaf's layer axis
gives the rank whole layers, which are broadcast from their owners, one
layer at a time: no tensor larger than one layer's local part is made.

Off a mesh the same layout holds with no axes: no cuts, no merges, one
replica, so one update serves both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..sharding import comm, rules


class Split(NamedTuple):
    """One cut of a dimension into `n` blocks, of which the rank holds
    block `index`, along the mesh axis `axis`."""

    dim: int
    axis: str
    n: int
    index: int


def splits(base, spec, shape, mesh) -> tuple:
    """The cuts that `spec` adds to `base` (each dimension's axes in `spec`
    start with its axes in `base`), each dimension's in its axes' order,
    the first major."""
    out = []
    nd = len(shape)
    base = tuple(base) + (None,) * (nd - len(base))
    spec = tuple(spec) + (None,) * (nd - len(spec))
    for d, (b, z) in enumerate(zip(base, spec)):
        b, z = rules.spec_axes(b), rules.spec_axes(z)
        if z[:len(b)] != b:
            raise ValueError(f"{spec} does not extend {base} on dimension {d}")
        for a in z[len(b):]:
            out.append(Split(d, a, mesh.size(mesh.mesh_dim_names.index(a)),
                             mesh.get_local_rank(a)))
    return tuple(out)


def part(t: torch.Tensor, cuts) -> torch.Tensor:
    """The rank's block of `t` under `cuts` (a view)."""
    for s in cuts:
        t = t.chunk(s.n, dim=s.dim)[s.index]
    return t


def gather(t: torch.Tensor, cuts, mesh) -> torch.Tensor:
    """The tensor whose block under `cuts` each rank holds as `t`: gathered
    over the cuts, the minor first."""
    for s in reversed(cuts):
        t = comm.all_gather(t, s.dim, comm.axes_group(mesh, (s.axis,)))
    return t


def shift(cuts, k: int) -> tuple:
    """`cuts` on a tensor with `k` more leading dimensions (k < 0: fewer)."""
    return tuple(s._replace(dim=s.dim + k) for s in cuts)


def _blocks(items: list, n: int) -> list:
    size = len(items) // n
    return [items[i * size:(i + 1) * size] for i in range(n)]


@dataclasses.dataclass(frozen=True)
class ZeroLeaf:
    """One leaf's ZeRO-1 layout on `mesh`.  Its tensors are taken with a
    leading axis of units: a stacked leaf's layers, else one unit, the leaf
    (a stacked leaf of one-dimensional layers, whose Adafactor reductions
    mix the layers, is one unit too: `whole`).

      mesh      the `DeviceMesh` (None: off a mesh);
      update    the cuts of the rank's slice of the parameter that it
                updates, on (units, *a unit's dims);
      state     state name -> (its cuts on (units, *its dims), relative to
                the state's base spec; the rank's local shape, JAX's dims);
      last, prev  the process groups of the mesh axes that split the
                leaf's last and second-to-last dimensions (None: none), over
                which Adafactor merges its row and column sums;
      replicas  the ranks that update the same slice.
    """

    mesh: object
    shape: tuple
    whole: bool
    update: tuple
    state: dict
    last: object
    prev: object
    replicas: int

    def units(self, params: list) -> list:
        """The leaf's local parts as its units."""
        if not self.whole:
            return list(params)
        return [torch.stack(params)] if len(self.shape) > len(params[0].shape) else [params[0]]

    def state_units(self, t: torch.Tensor) -> torch.Tensor:
        """A state tensor with its leading axis of units."""
        return t[None] if self.whole else t

    def mine(self, n: int) -> list:
        """The indices of the units whose slice the rank updates (a split of
        the unit axis gives it a block of them)."""
        idx = list(range(n))
        for s in self.update:
            if s.dim == 0:
                idx = _blocks(idx, s.n)[s.index]
        return idx

    @property
    def inner(self) -> tuple:
        """The update's cuts of one unit's dimensions."""
        return shift(tuple(s for s in self.update if s.dim > 0), -1)

    def rebuild(self, units: list) -> None:
        """Each unit's local part whole again after the ranks updated their
        slices: the slices gathered over the unit's cuts, then each unit
        broadcast from the rank that updated it over a cut of the unit
        axis (the minor cut first)."""
        inner = self.inner
        if inner:
            for i in self.mine(len(units)):
                units[i].copy_(gather(part(units[i], inner), inner, self.mesh))
        lead = [s for s in self.update if s.dim == 0]
        for k in reversed(range(len(lead))):
            dom = list(range(len(units)))
            for s in lead[:k]:
                dom = _blocks(dom, s.n)[s.index]
            group = comm.axes_group(self.mesh, (lead[k].axis,))
            for owner, blk in enumerate(_blocks(dom, lead[k].n)):
                for i in blk:
                    comm.broadcast(units[i], owner, group)


def _group(mesh, ax):
    axes = rules.spec_axes(ax)
    return comm.axes_group(mesh, axes) if axes else None


# the axes of a model off a mesh: none
NO_MESH = rules.MeshShape((), ())


def leaf_layout(mesh, shape: tuple, stacked: bool, spec, optimizer: str) -> ZeroLeaf:
    """The `ZeroLeaf` of a leaf of JAX's `shape` (a stacked leaf's layer
    axis first) and parameter `spec` on `mesh` (None: off a mesh) for
    `optimizer`'s state (`rules.zero1`; Adafactor's `rules.factor_specs`)."""
    ms = NO_MESH if mesh is None else mesh
    nd = len(shape)
    ps = rules.P(*(tuple(spec) + (None,) * (nd - len(spec))))
    factored = optimizer == "adafactor" and nd >= 2
    # a unit axis of its own for a leaf that is not taken layer by layer
    whole = not stacked or (factored and nd == 2)
    k = 1 if whole else 0
    state = {}
    if optimizer == "adamw":
        update = rules.zero1(ps, shape, ms)
        state = {name: (shift(splits(ps, update, shape, ms), k),
                        rules.spec_shape(shape, update, ms)) for name in ("m", "v")}
    elif factored:
        f = rules.factor_specs(ps, shape, ms)
        vc_shape = shape[:-2] + shape[-1:]
        state["vr"] = (shift(splits(ps[:-1], f["vr"], shape[:-1], ms), k),
                       rules.spec_shape(shape[:-1], f["vr"], ms))
        state["vc"] = (shift(splits(rules.P(*ps[:-2], ps[-1]), f["vc"], vc_shape, ms), k),
                       rules.spec_shape(vc_shape, f["vc"], ms))
        update = rules.zero1(ps, shape, ms)
    else:
        state["v"] = ((), rules.spec_shape(shape, ps, ms))
        update = ps
    sizes = rules.mesh_axis_sizes(ms)
    held = math.prod(sizes[a] for ax in update for a in rules.spec_axes(ax))
    return ZeroLeaf(mesh, shape, whole, shift(splits(ps, update, shape, ms), k), state,
                    _group(mesh, ps[-1]) if nd else None,
                    _group(mesh, ps[-2]) if nd >= 2 else None,
                    math.prod(tuple(ms.shape)) // held)


def zero_layout(leaves, cfg, mesh, optimizer: str) -> dict:
    """name -> `leaf_layout` of every leaf of `models.lm.param_leaves` on
    `mesh` (a `DeviceMesh`) by its `rules.param_specs`, the layout of
    `rules.opt_state_specs`; off a mesh (None) every leaf whole."""
    pspecs = ({lf.name: rules.P() for lf in leaves} if mesh is None
              else rules.param_specs(leaves, cfg, mesh))
    return {lf.name: leaf_layout(mesh, rules._leaf_shape(lf), lf.stacked, pspecs[lf.name],
                                 optimizer) for lf in leaves}
