"""A training checkpoint crosses between the packages: the port's training
state listed as JAX's checkpoint holds it (`train.step.state_tensors`:
the flattened ``{"opt", "params", "step"}`` tree, in its order, under its
key paths, each run of layers stacked), so the port's loop resumes a JAX
run's checkpoint and JAX's loop resumes the port's.

Each case (reduced gemma-7b with AdamW and with Adafactor here, reduced
deepseek-v3-671b with AdamW in `test_torch_checkpoint_cross_moe.py` and
`_moe_back.py`, so that pytest-xdist's workers share them; all f32): an
unbroken 4-step run of one
package writes checkpoints at steps 2 and 4; the other package's loop
resumes from the step-2 checkpoint and runs steps 2 and 3, whose losses
must be within 1e-5 of the unbroken run's (the port's training parity
bound, `tests/test_torch_optim.py`).
"""

import os
import shutil

import pytest

import jax
from repro.configs import reduced_config as jax_reduced_config
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.launch.mesh import make_host_mesh
from repro.train import checkpoint as jck
from repro.train import loop as jloop

from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import lm as tlm
from repro_torch.train import checkpoint as ck
from repro_torch.train import loop
from repro_torch.train import step as tstep

STEPS, EVERY, LR, LOSS_TOL = 4, 2, 0.5, 1e-5
QUIET = lambda *_: None  # noqa: E731


def _streams(cfg):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return TokenStream(**kw), JaxTokenStream(**kw)


def _jax(cfg_j, stream, ckpt_dir, optimizer):
    _, hist = jloop.train(cfg_j, make_host_mesh(), stream, steps=STEPS, ckpt_dir=ckpt_dir,
                          ckpt_every=EVERY, optimizer=optimizer, peak_lr=LR, log_every=1,
                          log=QUIET, async_save=False)
    return hist


def _port(cfg, stream, ckpt_dir, optimizer):
    _, hist = loop.train(cfg, stream, steps=STEPS, ckpt_dir=ckpt_dir, ckpt_every=EVERY,
                         optimizer=optimizer, peak_lr=LR, log_every=1, log=QUIET,
                         async_save=False, device="cpu")
    return hist


def _step2(src, dst):
    """`dst` holding only `src`'s step-2 checkpoint."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, "step_00000002"), os.path.join(dst, "step_00000002"))
    return dst


def resume_across(tmp_path, arch, optimizer, direction):
    """`direction` "jax->port": JAX's unbroken run against the port resumed
    from its step 2; "port->jax" the reverse."""
    cfg = reduced_config(arch).replace(dtype="float32")
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    stream, stream_j = _streams(cfg)
    d = str(tmp_path)
    if direction == "jax->port":
        unbroken = _jax(cfg_j, stream_j, f"{d}/run", optimizer)
        resumed = _port(cfg, stream, _step2(f"{d}/run", f"{d}/resume"), optimizer)
    else:
        unbroken = _port(cfg, stream, f"{d}/run", optimizer)
        resumed = _jax(cfg_j, stream_j, _step2(f"{d}/run", f"{d}/resume"), optimizer)
    assert [h["step"] for h in resumed] == [2, 3]
    for got, want in zip(resumed, unbroken[2:]):
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_a_checkpoint_resumes_in_the_other_package(tmp_path, optimizer, direction):
    resume_across(tmp_path, "gemma-7b", optimizer, direction)


@pytest.mark.parametrize("arch,n_leaves", [("gemma-7b", 35), ("deepseek-v3-671b", 110)])
def test_the_train_state_has_jaxs_leaves(tmp_path, arch, n_leaves):
    """JAX's count and key paths, in JAX's order; JAX's `restore` reads the
    port's checkpoint into JAX's state tree, value for value."""
    import numpy as np

    from repro.train import step as jstep

    cfg = reduced_config(arch).replace(dtype="float32")
    state = tstep.init_state(cfg, device="cpu", model=tlm.LM(cfg, device="cpu"))
    tensors = tstep.state_tensors(state)
    assert len(tensors) == n_leaves
    cfg_j = jax_reduced_config(arch).replace(dtype="float32")
    target = jstep.init_state(jax.random.key(1), cfg_j)
    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(target)[0]]
    assert list(tensors) == paths
    ck.save(str(tmp_path), 3, tensors)
    out, step = jck.restore(str(tmp_path), target)
    assert step == 3
    for got, want in zip(jax.tree_util.tree_leaves(out), tensors.values()):
        np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())
