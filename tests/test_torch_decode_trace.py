"""A decode step over the model axis, traced on a fake process group: one
step on a (1, 4) ("data", "model") mesh as rank 3, against the same step
unsharded (`launch.dryrun.trace_cell`), on the meta device.

The fake process group is process-wide, as in `tests/test_torch_dryrun.py`,
so the traces run in a subprocess of their own and hand their numbers back
as JSON.

  * the rank's cache (`lm.init_cache(mesh=)`, `rules.cache_specs`: the
    time axis over "model") is at most a quarter (+ 1%) of the unsharded
    step's whole cache, for the tensor-parallel layout (reduced gemma-7b
    at 16 q and 16 KV heads) and for reduced deepseek-v3-671b (MLA, split-K
    alone, and the MoE over ("data", "model"));
  * under "tp" the rank's products are at most 0.35 of the unsharded
    step's (a quarter of every projection, head and FFN product, the
    attention over a quarter of the slots, the vocab-parallel head);
  * the MoE decode runs the rank's experts where they lie: no op of the
    step makes a tensor of a whole expert stack's shape, (E, D, F) or
    (E, F, D), as a gather of the stack would.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, T = 2, 64
FLOPS_BOUND, CACHE_BOUND = 0.35, 0.25 * 1.01

JOB = r"""
import json
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import lm
from repro_torch.models.config import ShapeConfig
from repro_torch.serve import cv_engine as engine
from repro_torch.sharding import rules

B, T = %(B)d, %(T)d
CASES = {"tp": reduced_config("gemma-7b").replace(n_heads=16, n_kv_heads=16, head_dim=8),
         "moe": reduced_config("deepseek-v3-671b")}


class Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(tuple(t.shape))
        return out


M.init_fake_process_group(4, 3)
mesh = M.make_mesh((1, 4), ("data", "model"), device="cpu", backend="fake")
out = {}
sh = ShapeConfig("decode", T, B, "decode")
for tag, cfg in CASES.items():
    one = dryrun.trace_cell(cfg, sh)
    rank = dryrun.trace_cell(cfg, sh, mesh)
    model = lm.shard_model(lm.LM(cfg, device="meta", generator=torch.Generator()), mesh)
    cache = lm.init_cache(cfg, B, T, device="meta", mesh=mesh)
    tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
    shapes = Shapes()
    with torch.inference_mode(), shapes:
        engine.make_decode_step(cfg, mesh)(model, cache, tokens)
    stacks = []
    if cfg.moe is not None:
        E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
        stacks = sorted(s for s in shapes.seen if s in ((E, D, F), (E, F, D)))
    out[tag] = {"layout": rules.decode_layout(cfg, mesh), "coords": rank["coords"],
                "rank": rank["cost"]["matmul_flops"], "one": one["cost"]["matmul_flops"],
                "cache": rank["memory"]["cache_bytes"], "cache_one": one["memory"]["cache_bytes"],
                "cache_global": rank["cache_bytes_global"], "stacks": stacks}
print(json.dumps(out))
""" % {"B": B, "T": T}


@pytest.fixture(scope="module")
def traces():
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", JOB], capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tag,layout", [("tp", "tp"), ("moe", "splitk")])
def test_the_rank_holds_a_quarter_of_the_cache(traces, tag, layout):
    t = traces[tag]
    assert t["layout"] == layout and t["coords"] == {"data": 0, "model": 3}
    assert t["cache_one"] == t["cache_global"] > 0
    assert t["cache"] <= CACHE_BOUND * t["cache_one"], t["cache"] / t["cache_one"]


def test_the_tp_rank_does_a_quarter_of_the_products(traces):
    t = traces["tp"]
    assert t["rank"] <= FLOPS_BOUND * t["one"], t["rank"] / t["one"]


def test_no_whole_expert_stack_is_made_on_the_rank(traces):
    assert traces["moe"]["stacks"] == []
