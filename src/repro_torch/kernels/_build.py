"""Build the CUDA sources under ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The libraries go under ``build/kernels/<hash>/`` at the checkout's root
(listed in ``.gitignore``), keyed by a hash of the source, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is not.  All missing libraries compile in parallel, one ``nvcc`` each.
A missing ``nvcc`` or a failed build raises `RuntimeError`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return path


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built, keyed by what its build reads."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` that is not built yet, all at once.
    Returns the seconds spent; the ptxas report of each build is kept
    beside its library as ``lib<name>.log``."""
    with _LOCK:
        t0 = time.perf_counter()
        todo = [(p.stem, lib_path(p.stem)) for p in sorted(CSRC.glob("*.cu"))]
        todo = [(name, out) for name, out in todo if not out.exists()]
        nvcc = _nvcc() if todo else None  # raise before anything is written
        procs = []
        for name, out in todo:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((name, out, tmp, proc))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The ptxas report (registers, shared memory, spills) of one build."""
    return lib_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS.setdefault(name, ctypes.CDLL(str(lib_path(name))))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device that all ``tensors`` lie on; raise unless each is
    a contiguous float32 tensor there."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32 tensors, got {t.dtype}")
    return dev


def on_device(dev: torch.device):
    """A context that makes `dev` the current CUDA device, or none when it
    already is (entering and leaving `torch.cuda.device` costs the host a
    few microseconds a call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def cuda_stream(dev: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``dev``'s current stream, for a launcher."""
    return torch.cuda.current_stream(dev).cuda_stream
