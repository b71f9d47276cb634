"""The model axis's work split, traced on a fake process group: one train
step on a (1, 4) ("data", "model") mesh, as the busiest rank of the model
axis (rank 3: its query slice is the last, the one that sees every key),
against the same step unsharded.

The fake process group is process-wide, as in `tests/test_torch_dryrun.py`,
so the traces run in a subprocess of their own and hand their numbers back
as JSON.

  * the tensor-parallel layout (reduced gemma-7b at 16 q and 16 KV heads):
    the rank's products at most 0.3 of the unsharded step's (a quarter of
    every projection, head and FFN product, and the plain attention
    backward's products over the rank's 4 heads of 16);
  * the sequence-parallel layout (reduced qwen2-72b, 8 over 2 heads): at
    most 0.4 (a quarter of every dense product, and the plain backward of
    the last query slice over all the keys: a quarter of the rows, all the
    columns);
  * the vocab-parallel loss: no tensor of the rank's rows x the sequence x
    the whole vocabulary is made anywhere in the step.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 64
BOUNDS = {"tp": 0.3, "sp": 0.4}

JOB = r"""
import json, sys
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding import rules

B, S = %(B)d, %(S)d
CASES = {"tp": reduced_config("gemma-7b").replace(n_heads=16, n_kv_heads=16, head_dim=8),
         "sp": reduced_config("qwen2-72b")}


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
sh = ShapeConfig("train", S, B, "train")
for tag, cfg in CASES.items():
    one = dryrun.trace_cell(cfg, sh)
    shapes = Shapes()
    with shapes:
        rank = dryrun.trace_cell(cfg, sh, mesh)
    out[tag] = {"layout": rules.model_layout(cfg, mesh, S), "coords": rank["coords"],
                "rank": rank["cost"]["matmul_flops"], "one": one["cost"]["matmul_flops"],
                "vocab": cfg.vocab_size,
                "full_logits": sorted(s for s in shapes.seen
                                      if len(s) >= 3 and s[-1] == cfg.vocab_size)}
print(json.dumps(out))
""" % {"B": B, "S": S}


@pytest.fixture(scope="module")
def traces():
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", JOB], capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_the_busiest_rank_does_a_quarter_of_the_products(traces, tag):
    t = traces[tag]
    assert t["layout"] == tag and t["coords"] == {"data": 0, "model": 3}
    assert t["rank"] <= BOUNDS[tag] * t["one"], t["rank"] / t["one"]


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_the_vocab_parallel_loss_makes_no_whole_vocabulary_tensor(traces, tag):
    """No activation with the whole vocabulary last (a (B, S, V) tensor or
    any other of three dimensions or more; the head's own (D, V) shape is
    made once, when the model is drawn)."""
    assert traces[tag]["full_logits"] == []
