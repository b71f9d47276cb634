"""Atomic checkpoints of named tensors (the counterpart of
`repro.train.checkpoint`), in the JAX package's on-disk layout:

  <dir>/step_<N>/
     manifest.json   the names (``paths``), shapes, logical dtypes and a
                     sha256 for every leaf
     leaf_<i>.npy    one file a leaf, bfloat16 stored as its raw uint16

  * atomic publish: writes go to ``step_<N>.tmp``, each file fsync'd, then
    a rename, so a crash mid-write never leaves a corrupt latest step;
  * integrity: each leaf's sha256 is checked on restore, and a corrupt or
    truncated step is skipped for the one before it;
  * keep-last-k garbage collection; `AsyncSaver` writes from a thread.

The leaves are named tensors in a fixed order; a training state's are
JAX's checkpoint's (`train.step.state_tensors`), so that either package
resumes the other's.  On a mesh, a DTensor leaf (or a `sharding.rules.
SpecPart`, a block of a ZeRO-1 spec that DTensor cannot say) is written
whole: every rank gathers it, rank 0 writes, and every rank waits for the
publish.  `restore` places each leaf on its target's device in its
target's dtype, or, elastically, as the rank's block on the mesh and in
the layout that `shardings` gives it (a DTensor or `SpecPart` target: its
own), whatever mesh wrote it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..sharding import comm, rules


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Does this process write (rank 0, or no process group)?"""
    return not _distributed() or dist.get_rank() == 0


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor -> (a host copy of it as written to disk, its logical
    dtype).  A copy also of a CPU tensor: training updates its tensors in
    place, so an `AsyncSaver` thread must not read the live ones.  A
    DTensor is gathered whole (every rank of its mesh takes part)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = comm.full(t.to_local(), t.device_mesh, t.placements)
    elif isinstance(t, rules.SpecPart):
        t = comm.spec_full(t.local, t.sharding.mesh, t.sharding.spec)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: its raw u16
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write(ckpt_dir: str, step: int, host: dict, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "n_leaves": len(host), "paths": list(host), "leaves": []}
    for i, (arr, logical) in enumerate(host.values()):
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"file": fname, "shape": list(arr.shape), "dtype": logical,
                                   "sha256": hashlib.sha256(arr.tobytes()).hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tensors: dict, *, keep: int = 3) -> str:
    """Synchronous atomic save of `tensors` (name -> tensor, in order).
    Returns the published directory.  In a process group every rank calls
    it: rank 0 writes, and all return after the publish."""
    host = {k: _host(t) for k, t in tensors.items()}
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _writer():
        path = _write(ckpt_dir, step, host, keep)
    if _distributed():
        dist.barrier()
    return path


class AsyncSaver:
    """Overlaps checkpoint I/O with the next training steps: `save` copies
    the tensors to the host before its thread starts."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir: str, step: int, tensors: dict, *, keep: int = 3):
        self.wait()
        host = {k: _host(t) for k, t in tensors.items()}
        if not _writer():
            return
        self._thread = threading.Thread(target=_write, args=(ckpt_dir, step, host, keep),
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(ckpt_dir: str, keep: int):
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _verify(path: str, manifest: dict) -> bool:
    for leaf in manifest["leaves"]:
        try:
            arr = np.load(os.path.join(path, leaf["file"]))
        except (OSError, ValueError, EOFError):  # truncated / garbage / missing file
            return False
        if hashlib.sha256(arr.tobytes()).hexdigest() != leaf["sha256"]:
            return False
    return True


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place(t: torch.Tensor, tgt, sharding):
    """A restored full tensor in its target's dtype: the rank's block on
    ``sharding``'s mesh (a `sharding.rules.NamedSharding`, or a DTensor or
    `SpecPart` target's own layout), as a DTensor or a `SpecPart`
    (`NamedSharding.wrap`), else on the target's device."""
    from torch.distributed.tensor import DTensor

    if sharding is None and isinstance(tgt, DTensor):
        sharding = rules.NamedSharding(tgt.device_mesh, tuple(tgt.placements))
    elif sharding is None and isinstance(tgt, rules.SpecPart):
        sharding, tgt = tgt.sharding, tgt.local
    if sharding is None:
        return t.to(device=tgt.device, dtype=tgt.dtype)
    mesh = sharding.mesh
    dev = torch.device(mesh.device_type, torch.cuda.current_device()
                       if mesh.device_type == "cuda" else None)
    return sharding.wrap(sharding.part(t).to(device=dev, dtype=tgt.dtype).contiguous())


def restore(ckpt_dir: str, target: dict, *, step: int | None = None,
            shardings: dict | None = None, verify: bool = True) -> tuple[dict, int]:
    """The newest usable step (or `step`) -> (tensors named as `target`,
    each in its target's dtype, the step).  A leaf goes to its target's
    device, or, elastic restore, as a DTensor onto the mesh and placements
    of its entry in `shardings` (name -> `sharding.rules.NamedSharding`), a
    DTensor target's own by default.  A step whose names differ from
    `target`'s, or that fails its checks, is skipped for an older one.
    Raises `FileNotFoundError` if none is usable."""
    shardings = shardings or {}
    candidates = [step] if step is not None else _steps(ckpt_dir)[::-1]
    names = list(target)
    for s in candidates:
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            continue
        with open(mf) as f:
            manifest = json.load(f)
        if manifest["n_leaves"] != len(names) or manifest["paths"] != names:
            continue
        if verify and not _verify(path, manifest):
            continue
        out = {}
        for name, meta in zip(names, manifest["leaves"]):
            t = _tensor(np.load(os.path.join(path, meta["file"])), meta["dtype"])
            out[name] = _place(t, target[name], shardings.get(name))
        return out, s
    raise FileNotFoundError(f"no usable checkpoint in {ckpt_dir}")
