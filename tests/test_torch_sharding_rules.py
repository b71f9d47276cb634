"""The port's sharding rules (`repro_torch.sharding.rules`), MoE all-to-all
plan and mesh builders against the JAX package's, on the CPU, in one
process.

JAX's rule functions read nothing of a mesh but its axis names and device
grid's shape (`mesh_axis_sizes`, `dp_axes`), so they run here on a stand-in
with those two attributes, as the port's run on a `MeshShape`: no devices,
no processes.  The parameter trees are shapes only: JAX's `jax.eval_shape`
of `init_params`, the port's model built on the meta device.  Every spec
must equal JAX's exactly."""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.sharding import rules as jrules

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.sharding import rules

MESHES = [((4, 2), ("data", "model")), ((2, 4), ("data", "model")), ((8, 1), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def jax_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _names(keypath) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)


def _flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_names(kp): tuple(sp) for kp, sp in leaves}


def _configs(arch):
    return [("published", get_config(arch), jax_get_config(arch)),
            ("reduced", reduced_config(arch), jax_reduced_config(arch))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jaxs(arch):
    for which, cfg, cfg_j in _configs(arch):
        shapes = jax.eval_shape(lambda k: jlm.init_params(k, cfg_j), jax.random.key(0))
        leaves = tlm.param_leaves(tlm.LM(cfg, device="meta"))
        assert [lf.name for lf in leaves] == list(
            _flat_specs(jax.tree.map(lambda _: jax.sharding.PartitionSpec(), shapes)))
        for shape, axes in MESHES:
            want = _flat_specs(jrules.param_specs(shapes, cfg_j, jax_mesh(shape, axes)))
            got = rules.param_specs(leaves, cfg, rules.MeshShape(shape, axes))
            assert {k: tuple(v) for k, v in got.items()} == want, (which, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jaxs(arch):
    from repro.configs import extra_inputs as jax_extra_inputs

    from repro_torch.configs import extra_inputs

    for which, cfg, cfg_j in _configs(arch):
        ctx = 16 if tlm.context_input(cfg) else None
        for shape, axes in MESHES:
            mesh, mesh_j = rules.MeshShape(shape, axes), jax_mesh(shape, axes)
            for B in (8, 6, 1):
                batch = {"tokens": torch.zeros(B, 4), "labels": torch.zeros(B, 4)}
                batch |= {k: torch.zeros(s) for k, (s, _) in extra_inputs(cfg, B, 4).items()}
                batch_j = {"tokens": np.zeros((B, 4)), "labels": np.zeros((B, 4))}
                batch_j |= {k: np.zeros(s) for k, (s, _) in jax_extra_inputs(cfg_j, B, 4).items()}
                got = {k: tuple(v) for k, v in rules.batch_specs(batch, mesh, cfg).items()}
                assert got == _flat_specs(jrules.batch_specs(batch_j, mesh_j, cfg_j))
                assert rules.batch_axes(B, mesh, cfg) == tuple(
                    a for a in np.atleast_1d(got["tokens"][0] or ()) if a)
            cache = tlm.init_cache(cfg, 8, 16, ctx_len=ctx, device="cpu")
            cache_j = jax.eval_shape(lambda: jlm.init_cache(cfg_j, 8, 16, ctx_len=ctx))
            want = _flat_specs(jrules.cache_specs(cache_j, mesh_j, cfg_j))
            want = {k: v for k, v in want.items() if not k.startswith("ctx")}  # port keeps no ctx
            got = rules.cache_specs(cache, mesh, cfg)
            flat = {}

            def walk(node, prefix):
                if isinstance(node, dict):
                    for k, v in node.items():
                        walk(v, f"{prefix}{k}.")
                elif isinstance(node, list):
                    for i, v in enumerate(node):
                        walk(v, f"{prefix}{i}.")
                else:
                    flat[prefix[:-1]] = tuple(node)

            walk(got, "")
            assert flat == want, (which, shape)


def _moe_cfgs():
    ds = reduced_config("deepseek-v3-671b")
    six = ds.replace(moe=ds.moe.__class__(**{**ds.moe.__dict__, "n_experts": 6}))
    return {"deepseek": ds, "arctic": reduced_config("arctic-480b"), "six": six,
            "published": get_config("deepseek-v3-671b")}


def test_a2a_plan_equals_jaxs():
    """Every outcome: ("data", "model"), ("model",) (6 experts on (4, 2)),
    and None (decode, one rank, an indivisible batch or sequence)."""
    seen = set()
    for name, cfg in _moe_cfgs().items():
        cfg_j = (jax_reduced_config("deepseek-v3-671b") if name != "published"
                 else jax_get_config("deepseek-v3-671b"))
        if name == "arctic":
            cfg_j = jax_reduced_config("arctic-480b")
        if name == "six":
            cfg_j = cfg_j.replace(moe=cfg_j.moe.__class__(**{**cfg_j.moe.__dict__,
                                                              "n_experts": 6}))
        for shape, axes in MESHES + [((1, 1), ("data", "model"))]:
            for xshape in ((4, 32, 64), (8, 16, 64), (4, 1, 64), (6, 32, 64), (4, 31, 64)):
                for cf in (None, 2.0):
                    got = tmoe._a2a_plan(rules.MeshShape(shape, axes), cfg, xshape, cf)
                    want = jmoe._a2a_plan(jax_mesh(shape, axes), cfg_j, xshape, cf)
                    if want is None:
                        assert got is None, (name, shape, xshape)
                        seen.add(None)
                        continue
                    keys = ("bdp", "a2a_axes", "all_axes", "L", "C", "n_ep")
                    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
                    seen.add(got["a2a_axes"])
    assert seen == {None, ("data", "model"), ("model",)}


def test_constrain_prunes_and_placements():
    mesh = rules.MeshShape((4, 2), ("data", "model"))
    sizes = jrules.mesh_axis_sizes(jax_mesh((4, 2), ("data", "model")))
    # JAX's test: a (3, 7) array under P("data", "model") keeps no axis
    assert rules.prune((3, 7), rules.P("data", "model"), mesh) == rules.P(None, None) == tuple(
        jrules._maybe(a, d, sizes) for a, d in zip(("data", "model"), (3, 7)))
    assert rules.prune((8, 4, 5), rules.P(("data", "model"), "model"), mesh) == rules.P(
        ("data", "model"), "model", None)
    # a plain tensor (every activation of the port) passes as it is
    x = torch.ones(3, 7)
    assert rules.constrain(x, rules.P("data", "model"), mesh) is x
    assert rules.make_hint(mesh, reduced_config("gemma-7b"))(x, "act") is x
    from torch.distributed.tensor import Replicate, Shard

    assert rules.placements(rules.P(("data", "model"), None), mesh) == (Shard(0), Shard(0))
    assert rules.placements(rules.P(None, "model"), mesh) == (Replicate(), Shard(1))
    assert rules.placements(rules.P("model", "data"), mesh) == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        rules.placements(rules.P(("model", "data")), mesh)
    assert repr(rules.P("data", None)) == "P('data', None)"


def test_hint_table_is_jaxs():
    for arch in ("gemma-7b", "xlstm-125m", "zamba2-2.7b", "deepseek-v3-671b"):
        for shape, axes in MESHES:
            hint = rules.make_hint(rules.MeshShape(shape, axes), get_config(arch))
            assert hint.mesh.shape == shape and hint.cfg.name == arch
            cfg_j = jax_get_config(arch)
            j = jrules.make_hint(jax_mesh(shape, axes), cfg_j)
            assert j.mesh.axis_names == axes
            # JAX's table lives in the closure of its hint
            (table,) = [c.cell_contents for c in j.__closure__
                        if isinstance(c.cell_contents, dict)]
            assert {k: tuple(v) for k, v in hint.table.items()} == {
                k: tuple(v) for k, v in table.items()}, (arch, shape)


def test_mesh_builders_raise_without_a_fitting_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_host_mesh(device="cpu")
    tmesh.init_process_group("cpu")
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert tuple(tmesh.make_host_mesh(device="cpu").shape) == (1, 1)
        with pytest.raises(ValueError, match="needs 8 ranks"):
            tmesh.make_mesh((4, 2), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            tmesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_host_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="not nccl"):
            tmesh.make_mesh((1, 1), ("data", "model"), device="cpu", backend="nccl")
        with pytest.raises(RuntimeError):
            tmesh.make_mesh((1, 1), ("data", "model"), device="cuda")  # no card here
    finally:
        dist.destroy_process_group()
