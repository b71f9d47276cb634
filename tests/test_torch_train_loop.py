"""The port's training loop, launcher and scripts on the CPU: the loop cases
of `tests/test_fault.py` (resume from a checkpoint, a checkpoint on
preemption), JAX's `test_loss_decreases` list on the port alone (8 steps on
a repeated batch at peak lr 3e-3, warmup 1), the launcher and the example
scripts at reduced size, the entry points' CUDA default, and the SSD scan's
two forms (in place without grad, out of place with it)."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import ssm
from repro_torch.train import checkpoint as ck
from repro_torch.train import loop
from repro_torch.train import step as tstep

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUIET = dict(log=lambda *_: None, device="cpu")


def test_train_loop_resume(tmp_path):
    cfg = reduced_config("gemma-7b")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    state, hist = loop.train(cfg, stream, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                             async_save=False, **QUIET)
    assert ck.latest_step(str(tmp_path)) == 4 and state["step"] == 4
    logged = []
    state2, hist2 = loop.train(cfg, stream, steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                               log_every=1, async_save=False, log=logged.append, device="cpu")
    assert state2["step"] == 6 and logged[0] == "[train] resumed from step 4"
    assert [h["step"] for h in hist2] == [4, 5]


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """Preempted (SIGTERM) after step 2 and resumed from its checkpoint, a
    run ends where an unbroken run of the same steps ends."""
    cfg = reduced_config("gemma-7b").replace(dtype="float32")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    kw = dict(steps=4, peak_lr=1e-2, warmup=1, log_every=1, device="cpu")
    full, h_full = loop.train(cfg, stream, log=lambda *_: None, **kw)

    def preempt(msg):
        if msg.startswith("[train] step 1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    part, _ = loop.train(cfg, stream, ckpt_dir=str(tmp_path), ckpt_every=100, log=preempt, **kw)
    assert part["step"] == 2 and ck.latest_step(str(tmp_path)) == 2
    resumed, h_res = loop.train(cfg, stream, ckpt_dir=str(tmp_path), log=lambda *_: None, **kw)
    assert [h["step"] for h in h_res] == [2, 3]
    assert [h["loss"] for h in h_res] == [h["loss"] for h in h_full[2:]]
    pf = dict(full["model"].named_parameters())
    for n, p in resumed["model"].named_parameters():
        assert torch.equal(p, pf[n]), n


def test_preemption_checkpoints(tmp_path):
    cfg = reduced_config("xlstm-125m")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    calls = {"n": 0}

    def fake_log(msg):
        calls["n"] += 1
        if calls["n"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # preempt after the first log

    state, _ = loop.train(cfg, stream, steps=50, ckpt_dir=str(tmp_path), ckpt_every=1000,
                          log=fake_log, log_every=1, async_save=False, device="cpu")
    assert ck.latest_step(str(tmp_path)) is not None
    assert state["step"] < 50
    assert signal.getsignal(signal.SIGTERM) is not None  # handlers restored


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-v3-671b", "zamba2-2.7b", "xlstm-125m"])
def test_loss_decreases(arch):
    """A few steps of training reduce the loss on a repeated batch."""
    cfg = reduced_config(arch)
    ts = tstep.make_train_step(cfg, peak_lr=3e-3, warmup=1)
    state = tstep.init_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))) for k in
             ("tokens", "labels")}
    losses = []
    for _ in range(8):
        state, m = ts(state, batch)
        losses.append(float(m["loss"]))
        assert float(m["grad_norm"]) > 0
    assert losses[-1] < losses[0], losses


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = reduced_config("gemma-7b")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstep.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(cfg, stream, steps=1, log=lambda *_: None)
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "gemma-7b", "--reduced", "--steps", "1"])


def _run(args, timeout=240):
    # one thread: the suite's workers already fill the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_launcher_trains_a_reduced_config_on_the_cpu(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch", "llama-3.2-vision-11b", "--reduced",
                "--device", "cpu", "--steps", "3", "--seq", "16", "--batch", "2",
                "--optimizer", "adafactor", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert "[launch] done: loss" in out
    assert ck.latest_step(str(tmp_path)) == 2


def test_example_scripts_run_on_the_cpu(tmp_path):
    out = _run(["scripts/torch_train_lm.py", "--device", "cpu", "--steps", "20", "--seq", "32",
                "--warmup", "2", "--ckpt", str(tmp_path)])
    assert "loss:" in out
    out = _run(["scripts/torch_serve_lm.py", "--device", "cpu", "--arch", "xlstm-125m",
                "--batch", "2", "--gen", "4"])
    assert "tokens in" in out


def test_ssd_scan_in_place_without_grad_equals_with_grad():
    """`ssd_scan` builds its (B, nc, L, L, H) tensors in place when grad is
    off (the serving prefill's memory) and out of place when it is on;
    both give the same numbers, and the gradient path runs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 20, 4, 8), generator=g, requires_grad=True)
    dt = torch.rand((2, 20, 4), generator=g) + 0.1
    A = -torch.rand(4, generator=g) - 0.5
    Bm, Cm = (torch.randn((2, 20, 1, 6), generator=g) for _ in range(2))
    with torch.no_grad():
        y0, s0 = ssm.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    y1, s1 = ssm.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())
    y1.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
