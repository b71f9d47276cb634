"""ZeRO-1 placement of the optimizer state (`sharding.rules.zero1`,
`opt_state_specs`, `spec_part`; `optim.zero`; `optim.adamw` on a mesh),
in one process.

  * the specs against JAX's dry run's `_zero1` / `opt_state_specs`
    (`src/repro/launch/dryrun.py`) for every arch's leaves on four meshes,
    exact;
  * each rank's block of a spec (`rules.spec_part`, and `local_part` of
    `placements` where the spec's order is the mesh's) against JAX's
    `NamedSharding` block of the same device, on 8 host devices in a
    subprocess (JAX's multi-device tests' way), exact; the ZeRO-1 specs
    that name a dimension's axes in another order than the mesh's
    (("model", "pod")) among them;
  * Adafactor on simulated shards: each rank's partial sums of g^2 + eps
    (`adamw._sq_sums`) merged over the ranks that split the reduced
    dimension and divided by its global length, its factors' blocks
    gathered, the denominator merged, and each rank's slice of the step
    (`adamw._zero_steps`) against JAX's `adafactor_update` of the whole
    leaf (its factors and its unclipped step), within 1e-6 relative; the
    squared steps summed once over the ranks that update each slice
    against the whole leaf's, within 1e-6 relative;
  * the global norm and clip a piece at a time, every shape (a scalar too);
  * one Adafactor train step of reduced deepseek-v3-671b traced on a fake
    (2, 2) process group (its own process, as `tests/test_torch_dryrun.py`
    keeps its fake group) under `roofline.cost.CostMode`: no tensor made
    in the update holds more bytes than 1.01 x the rank's largest local
    parameter (f32 throughout), and the traced state is `opt_bytes_zero1`.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from conftest import run_subprocess

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm
from repro_torch.optim import adamw, zero
from repro_torch.sharding import rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "pod": ((16, 16), ("data", "model")), "multipod": ((2, 16, 16), ("pod", "data", "model"))}
REL = 1e-6


def _jax_dryrun():
    """JAX's `repro.launch.dryrun`, imported with ``XLA_FLAGS`` as it was:
    its import sets 512 host devices, which must not reach this process's
    JAX backend (not initialised by the import)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jd


@pytest.fixture(scope="module")
def leaves():
    return {a: lm.param_leaves(lm.LM(get_config(a), device="meta", generator=torch.Generator()))
            for a in ARCHS}


def _norm(spec) -> tuple:
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a for a in tuple(spec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_are_jax_dryruns(arch, mesh, leaves):
    import jax
    from jax.sharding import PartitionSpec as JP

    jd = _jax_dryrun()
    shape, names = MESHES[mesh]
    ms = rules.MeshShape(shape, names)
    jmesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    lv = leaves[arch]
    pspecs = rules.param_specs(lv, get_config(arch), ms)
    shapes = [jax.ShapeDtypeStruct(rules._leaf_shape(lf), np.float32) for lf in lv]
    jspecs = [JP(*pspecs[lf.name]) for lf in lv]
    for opt in ("adamw", "adafactor"):
        got = rules.opt_state_specs(lv, pspecs, ms, opt)
        want = jd.opt_state_specs(None, shapes, jspecs, jmesh, opt)
        if opt == "adamw":
            for lf, w in zip(lv, want["m"]):
                assert _norm(got["m"][lf.name]) == _norm(w), lf.name
                assert _norm(got["v"][lf.name]) == _norm(w), lf.name
                assert _norm(rules.zero1(pspecs[lf.name], rules._leaf_shape(lf), ms)) == _norm(
                    jd._zero1(JP(*pspecs[lf.name]), rules._leaf_shape(lf), jmesh))
        else:
            assert [{k: _norm(v) for k, v in d.items()} for d in got["f"]] == [
                {k: _norm(v) for k, v in d.items()} for d in want["f"]]


class StubMesh:
    """The rank at `coord` of a mesh of `shape` over `names`, as much of a
    `DeviceMesh` as the rules read (no processes): a group is its axes'
    label."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self.coord = tuple(shape), tuple(names), tuple(coord)

    def size(self, i=None):
        return int(np.prod(self.shape)) if i is None else self.shape[i]

    def get_local_rank(self, dim):
        return self.coord[dim if isinstance(dim, int) else self.mesh_dim_names.index(dim)]

    def get_group(self, dim):
        return dim


# (mesh, spec, tensor shape): in and out of the mesh's order
BLOCK_CASES = [
    ("4x2", (("data", "model"),), (16,)),
    ("4x2", ("model", "data"), (4, 8)),
    ("4x2", (("model", "data"), None), (16, 3)),
    ("4x2", (None, ("data", "model")), (2, 8)),
    ("2x2x2", (("model", "pod"), "data"), (8, 4)),
    ("2x2x2", (("data", "pod"),), (8,)),
    ("2x2x2", (("pod", "data", "model"),), (16,)),
    ("2x2x2", ("model", ("data", "pod")), (4, 8)),
]

JAX_BLOCKS = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = []
for shape, names, spec, tshape in json.loads(%(cases)r):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), tuple(names))
    spec = P(*[tuple(a) if isinstance(a, list) else a for a in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
    out.append({",".join(map(str, c)): [[s.start or 0, n if s.stop is None else s.stop]
                                        for s, n in zip(idx[mesh.devices[c]], tshape)]
                for c in np.ndindex(*shape)})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_blocks():
    cases = [[list(MESHES[m][0]), list(MESHES[m][1]), [list(a) if isinstance(a, tuple) else a
                                                         for a in spec], list(t)]
             for m, spec, t in BLOCK_CASES]
    out = run_subprocess(JAX_BLOCKS % {"cases": json.dumps(cases)}, devices=8, timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(BLOCK_CASES)))
def test_spec_part_is_jax_named_sharding_block(case, jax_blocks):
    mesh, spec, tshape = BLOCK_CASES[case]
    shape, names = MESHES[mesh]
    spec = rules.P(*spec)
    t = torch.arange(int(np.prod(tshape))).reshape(tshape)
    for coord in np.ndindex(*shape):
        m = StubMesh(shape, names, coord)
        block = jax_blocks[case][",".join(map(str, coord))]
        want = t[tuple(slice(a, b) for a, b in block)]
        got = rules.spec_part(t, m, spec)
        assert torch.equal(got, want), (spec, coord)
        assert tuple(got.shape) == rules.spec_shape(tshape, spec, m)
        if rules.in_mesh_order(spec, m):
            assert torch.equal(rules.local_part(t, m, rules.placements(spec, m)), want)
        else:
            with pytest.raises(ValueError):
                rules.placements(spec, m)


def test_zero1_names_axes_out_of_the_mesh_order_on_a_multipod_mesh():
    ms = rules.MeshShape(*MESHES["2x2x2"])
    spec = rules.zero1(rules.P("model", None), (8, 4), ms)
    assert spec == rules.P(("model", "pod"), None) and not rules.in_mesh_order(spec, ms)


# -- Adafactor on simulated shards -------------------------------------------------

# (leaf shape, stacked, parameter spec) on a (2, 2) ("data", "model") mesh:
# ZeRO-1 cuts the rows' "data" block over "model"; a stacked leaf of
# matrices over its layer axis; a stacked leaf of vectors (one unit); an
# expert stack, taken an expert at a time, over both axes already (no cut)
SHARD_CASES = [((8, 6), False, ("data", None), True),
               ((2, 8, 6), True, (None, "data", None), True),
               ((4, 6), True, (None, None), True),
               ((2, 4, 8, 6), True, (None, "model", "data", None), False)]
SIM = ((2, 2), ("data", "model"))
EPS = 1e-30


def _sum_over(parts: dict, axes: tuple) -> dict:
    """Each rank's value summed over the ranks that differ from it only
    along `axes` (an all-reduce over their group)."""
    names = SIM[1]
    out = {}
    for c in parts:
        peers = [d for d in parts if all(d[i] == c[i] for i, n in enumerate(names) if n not in axes)]
        out[c] = sum(parts[d] for d in peers)
    return out


def _gather(parts: dict, cuts_of: dict) -> dict:
    """Each rank's tensor gathered over its cuts (`zero.gather`, the minor
    first), from the ranks' blocks."""
    names = SIM[1]
    cur = dict(parts)
    for k in reversed(range(len(next(iter(cuts_of.values()))))):
        nxt = {}
        for c, cuts in cuts_of.items():
            s = cuts[k]
            i = names.index(s.axis)
            peers = [tuple(j if n == i else c[n] for n in range(len(c))) for j in range(s.n)]
            nxt[c] = torch.cat([cur[p] for p in peers], dim=s.dim)
        cur = nxt
    return cur


def _jax_adafactor(G, vr, vc, count: int):
    """JAX's `adafactor_update` of one leaf, gradient `G`, from the factors
    `vr`, `vc` at `count`: (its factors, its step unclipped)."""
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw

    def arr(t):
        return jnp.asarray(t.numpy())

    params, state = jadamw.adafactor_update(
        {"w": arr(G)}, {"f": [{"vr": arr(vr), "vc": arr(vc)}],
                        "count": jnp.asarray(count, jnp.int32)},
        {"w": jnp.zeros(G.shape, jnp.float32)}, lr=-1.0, eps=EPS, clip=float("inf"))
    f = {k: torch.from_numpy(np.array(v)) for k, v in state["f"][0].items()}
    return f, torch.from_numpy(np.array(params["w"]))


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_adafactor_merges_on_simulated_shards_are_the_whole_leafs(case):
    shape, stacked, spec, cut = SHARD_CASES[case]
    gen = torch.Generator().manual_seed(case)
    G = torch.randn(shape, generator=gen)
    vr0 = torch.rand(shape[:-1], generator=gen) + 0.5
    vc0 = torch.rand(shape[:-2] + shape[-1:], generator=gen) + 0.5
    count = 2
    b2 = 1.0 - torch.tensor(count + 1.0) ** -0.8
    # the whole leaf: JAX's factors, and its unclipped step as the update of
    # a zero parameter at lr -1
    f, whole = _jax_adafactor(G, vr0, vc0, count)
    R, C = shape[-2], shape[-1]
    g2 = G * G + EPS
    # each simulated rank
    ranks = {c: StubMesh(*SIM, c) for c in np.ndindex(*SIM[0])}
    z = {c: zero.leaf_layout(m, shape, stacked, rules.P(*spec), "adafactor")
         for c, m in ranks.items()}
    assert all(bool(zc.update) == cut for zc in z.values())  # ZeRO-1's cuts of the slices
    gl = {c: rules.spec_part(G, m, rules.P(*spec)) for c, m in ranks.items()}
    gu = {c: z[c].units(list(gl[c]) if stacked else [gl[c]]) for c in ranks}
    sums = {c: adamw._sq_sums(gu[c], EPS) for c in ranks}
    rows = _sum_over({c: s[0] for c, s in sums.items()}, rules.spec_axes(spec[-1]))
    cols = _sum_over({c: s[1] for c, s in sums.items()}, rules.spec_axes(spec[-2]))
    for c, m in ranks.items():
        lead = (lambda t: t[None]) if z[c].whole else (lambda t: t)
        want_r = rules.spec_part(lead(g2.mean(dim=-1)), m, rules.P(None, *spec[:-1]) if z[c].whole
                                 else rules.P(*spec[:-1]))
        assert torch.allclose(rows[c] / C, want_r, rtol=REL, atol=0)
    def base_spec(key, c):  # a factor's spec in its parameter's layout
        base = spec[:-1] if key == "vr" else spec[:-2] + spec[-1:]
        return rules.P(None, *base) if z[c].whole else rules.P(*base)

    blocks = {}
    for key, mean, prior in (("vr", rows, vr0), ("vc", cols, vc0)):
        n = C if key == "vr" else R
        part = {}
        for c, m in ranks.items():
            cuts = z[c].state[key][0]
            # the rank's stored block, updated from its part of the mean
            blk = zero.part(rules.spec_part(z[c].state_units(prior), m, base_spec(key, c)),
                            cuts).clone()
            assert tuple(blk.shape[1:] if z[c].whole else blk.shape) == z[c].state[key][1]
            part[c] = blk.mul_(b2).add_((1 - b2) * zero.part(mean[c] / n, cuts))
        blocks[key] = _gather(part, {c: z[c].state[key][0] for c in ranks})
        for c, m in ranks.items():
            want = rules.spec_part(z[c].state_units(f[key]), m, base_spec(key, c))
            assert torch.allclose(blocks[key][c], want, rtol=REL, atol=0), key
    fac = {}
    den = _sum_over({c: blocks["vr"][c].sum(dim=-1) for c in ranks}, rules.spec_axes(spec[-2]))
    for c in ranks:
        fac[c] = (blocks["vr"][c], blocks["vc"][c], torch.clamp(den[c] / R, min=EPS))
    total = 0.0
    for c, m in ranks.items():
        lead = rules.P(None, *spec) if z[c].whole else rules.P(*spec)
        wl = rules.spec_part(z[c].state_units(whole), m, lead)
        for i in z[c].mine(len(gu[c])):
            want = zero.part(wl[i], z[c].inner)
            for key, st in adamw._zero_steps(gu[c][i], i, z[c], fac[c], None, EPS):
                assert torch.allclose(st, want[key], rtol=REL, atol=0)
                total += float(torch.sum(st * st)) / z[c].replicas
    assert abs(total - float(torch.sum(whole * whole))) <= REL * float(torch.sum(whole * whole))


# -- the update's largest tensor, traced on a fake group ----------------------------

TRACE_JOB = r"""
import json
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.roofline.cost import CostMode
from repro_torch.sharding import rules
from repro_torch.train import step as tstep


class Largest(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


M.init_fake_process_group(4, 0)
mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu", backend="fake")
cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
model = lm.shard_model(lm.LM(cfg, device="meta", generator=torch.Generator()), mesh)
state = tstep.init_state(cfg, optimizer="adafactor", model=model)
largest = Largest()
update = tstep._update


def traced_update(*args, **kwargs):
    with largest:
        return update(*args, **kwargs)


tstep._update = traced_update
fn = tstep.make_train_step(cfg, mesh, optimizer="adafactor")
batch = dryrun.input_specs(cfg, ShapeConfig("t", 32, 8, "train"))
cm = CostMode()
cm.hold((model, state["opt"], batch))
with cm:
    fn(state, batch)
leaves = lm.param_leaves(model)
param = max(p.to_local().numel() * p.to_local().element_size() for p in model.parameters())
print(json.dumps({"update": largest.bytes, "param": param,
                  "opt": dryrun.tree_bytes(state["opt"]),
                  "zero1": dryrun.opt_bytes_zero1(leaves, rules.param_specs(leaves, cfg, mesh),
                                                  mesh, "adafactor"),
                  "collectives": cm.collective_summary()["count"]}))
"""


def test_the_adafactor_update_makes_no_tensor_larger_than_a_local_parameter():
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", TRACE_JOB], capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    t = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 0 < t["update"] <= 1.01 * t["param"], t
    assert t["opt"] == t["zero1"] > 0 and t["collectives"] > 0


@pytest.mark.parametrize("shape", [(), (5,), (7, 3), (2, 3, 4)])
def test_the_norm_and_the_clip_take_every_shape_a_piece_at_a_time(shape, monkeypatch):
    """`train.step`'s global norm and clip go a piece at a time
    (`optim.adamw.pieces`, here forced small): a scalar's (a cross-attention
    gate), a vector's, a matrix's row blocks, a stack's slices cover the
    tensor once, and give the whole tensor's norm and clipped values."""
    from repro_torch.train import step as tstep

    monkeypatch.setattr(adamw, "PIECE", 4)
    g = 3 * torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert sum(g[k].numel() for k in adamw.pieces(shape)) == g.numel()
    want_norm = torch.sqrt(torch.sum(g * g))
    want = g * torch.clamp(1.0 / want_norm, max=1.0)
    got = g.clone()
    norm = tstep._clip_by_global_norm([[got]], 1.0)
    assert torch.allclose(norm, want_norm, rtol=REL) and torch.allclose(got, want, rtol=REL)
