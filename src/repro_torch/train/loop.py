"""The training loop (the counterpart of `repro.train.loop`): steps,
checkpoints and fault tolerance wired together.

Auto-resumes from the latest valid checkpoint, checkpoints on SIGTERM
(preemption), watches for stragglers and logs metrics.  Each step ends in
a device synchronisation where JAX blocks until the loss is ready, so the
step times are device times.  On a mesh (``mesh=``), every rank runs the
loop on the global batches and the sharded state (`train.step`); the
checkpoint holds whole tensors, so a run resumes onto another mesh
(elastic restart), every rank stops at the same step on a preemption of
any, and only rank 0 logs.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from . import checkpoint as ckpt_mod
from .fault import PreemptionGuard, StepTimer, StragglerWatchdog
from ..sharding import comm
from .step import init_state, load_state_tensors, make_train_step, state_tensors


def train(cfg, data_stream, *, steps: int, mesh=None, ckpt_dir: str | None = None,
          ckpt_every: int = 100, optimizer: str = "adamw", peak_lr: float = 3e-4,
          warmup: int = 200, log_every: int = 10, log: Callable[[str], None] = print, state=None,
          async_save: bool = True, device=None):
    """Runs training steps up to `steps` -> (state, history), as JAX's:
    with no `state`, a fresh one on `device` (None = "cuda") from a
    generator seeded 0, resumed from `ckpt_dir`'s latest valid step if
    there is one.  `data_stream.batch_at(i)` gives step i's batch (CPU
    tensors, moved to the model's device).  `history` holds ``step``,
    ``loss`` and ``seconds`` of every logged step.  `warmup` is the
    schedule's (JAX's loop keeps its default of 200).  `mesh`: a
    `launch.mesh` mesh to shard the state over (module docstring)."""
    if mesh is not None and dist.get_rank() != 0:
        log = lambda _msg: None  # noqa: E731
    step_fn = make_train_step(cfg, mesh, optimizer=optimizer, peak_lr=peak_lr, warmup=warmup,
                              total_steps=max(steps, 1))
    start_step = 0
    if state is None:
        dev = resolve_device(device)
        state = init_state(cfg, optimizer=optimizer, device=dev, mesh=mesh,
                           generator=torch.Generator(dev).manual_seed(0))
        if ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
            tensors, start_step = ckpt_mod.restore(ckpt_dir, state_tensors(state))
            load_state_tensors(state, tensors)
            log(f"[train] resumed from step {start_step}")
    dev = state["model"].device

    guard = PreemptionGuard()
    watchdog = StragglerWatchdog(
        on_alarm=lambda i, s, e: log(f"[straggler] step {i}: {s:.3f}s vs EWMA {e:.3f}s"))
    saver = ckpt_mod.AsyncSaver() if async_save else None
    history = []
    try:
        for i in range(start_step, steps):
            batch = {k: v.to(dev) for k, v in data_stream.batch_at(i).items()}
            with StepTimer() as t:
                state, metrics = step_fn(state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            watchdog.step(i, t.seconds)
            if i % log_every == 0 or i == steps - 1:
                loss = float(metrics["loss"])
                history.append({"step": i, "loss": loss, "seconds": t.seconds})
                log(f"[train] step {i} loss {loss:.4f} ({t.seconds:.2f}s)")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                (saver.save if saver else ckpt_mod.save)(ckpt_dir, i + 1, state_tensors(state))
            if _stop(guard, mesh, dev):
                log(f"[train] preemption requested; checkpointing at step {i + 1}")
                if saver:
                    saver.wait()
                if ckpt_dir:
                    ckpt_mod.save(ckpt_dir, i + 1, state_tensors(state))
                break
    finally:
        if saver:
            saver.wait()
        guard.restore_handlers()
    return state, history


def _stop(guard: PreemptionGuard, mesh, dev) -> bool:
    """Was a preemption requested (on a mesh: of any rank)?"""
    if mesh is None:
        return guard.requested
    flag = torch.tensor(float(guard.requested), device=dev)
    return bool(comm.all_reduce(flag, dist.group.WORLD, op=dist.ReduceOp.MAX) > 0)
