"""Window executor: the `stencil_chain` CUDA kernel's wrapper, its host-side
planner, and its plain PyTorch version.

Replaces `repro.kernels.stencil.exec_window.window_kernel` (TPU, Pallas),
and computes what `exec_streaming.streaming_kernel` computes.  Bound on an
H100: bytes (each input pixel read once, each output band written once;
the arithmetic is far below the fp32 rate), so the kernel keeps every
intermediate band in shared memory and writes each band once.  One block
per (plane, output tile) loads the tile's window, clamping coordinates only
on that read, and runs the chain there; see ``csrc/stencil_chain.cu``.

`compile_chain` turns a chain into the kernel's step table: which
shared-memory slot each stage reads and writes, which halo the source band
still carries, and after which step each output band is final and stored.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ...core.device import DEFAULT, LaunchConfig
from .. import _build, counters, ref
from .ir import resolve_chain
from .plan import SEPARABLE_OPS, chain_accumulated_halo

MAX_STEPS = 32
MAX_WEIGHTS = 512
# stage op -> the kernels' op code (csrc/stencil_ops.cuh `stencil::Op`)
OP_CODES = {
    "sep_filter": 0,
    "erode": 1,
    "grad_mag": 2,
    "filter2d": 4,
    "dilate": 5,
    "box": 6,
    "threshold": 7,
    "affine": 8,
}
_STORE = 3
CARRIERS = (torch.uint8, torch.float32)
_STEP_FIELDS = ("op", "src", "dst", "tmp", "kh", "kw", "wx", "wy", "rh", "rw", "store", "pad")


class _Step(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in _STEP_FIELDS]


class _Program(ctypes.Structure):
    """Mirror of ``ChainProgram`` in csrc/stencil_chain.cu."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("pad", ctypes.c_int * 3),
        ("steps", _Step * MAX_STEPS),
        ("weights", ctypes.c_float * MAX_WEIGHTS),
    ]


PROGRAM_BYTES = ctypes.sizeof(_Program)
# stencil_chain_launch(in, out, prog, n, h, w, tile_h, tile_w, ph, pw, n_slots, threads, u8,
#                      stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@dataclass(frozen=True)
class ChainProgram:
    """A chain compiled for the kernel: steps as field dicts, the flat tap
    weights, the shared-memory slots it needs and the bands it outputs."""

    steps: tuple
    weights: tuple
    n_slots: int
    n_bands: int
    halo: tuple

    def packed(self) -> bytes:
        p = _Program(n_steps=len(self.steps))
        for k, st in enumerate(self.steps):
            p.steps[k] = _Step(**st)
        for k, v in enumerate(self.weights):
            p.weights[k] = v
        return bytes(p)


def check_ported(resolved, kernel: str) -> None:
    """Raise `NotImplementedError` for a stage the kernels do not run yet."""
    for op, mode, _, stride, up, *_ in resolved:
        if op not in OP_CODES or mode not in ("map", "tap") or stride != (1, 1) or up != (1, 1):
            raise NotImplementedError(f"{kernel}: {op!r} in {mode!r} mode is not ported to the kernel yet")


def stage_params(s, weights: list, carrier: torch.dtype) -> dict:
    """One stage's op code, extents and the offsets of its taps or scalars,
    appending them to `weights` (the step table's shared weight array).
    Threshold's maxval goes in as the carrier holds it (packed on u8)."""
    hy, hx = s.halo
    kh, kw = 2 * hy + 1, 2 * hx + 1
    wx = wy = len(weights)
    if s.op == "sep_filter":
        kx, ky = s.weights
        if (len(ky), len(kx)) != (kh, kw):
            raise NotImplementedError("stencil kernels: even-length filter taps")
        weights += kx.tolist()
        wy = len(weights)
        weights += ky.tolist()
    elif s.op == "filter2d":
        if tuple(s.weights[0].shape) != (kh, kw):
            raise NotImplementedError("stencil kernels: even-sized filter2d kernels")
        weights += s.weights[0].reshape(-1).tolist()
    elif s.op == "box":
        weights.append(float(torch.tensor(1.0 / (kh * kw), dtype=torch.float32)))
    elif s.op == "threshold":
        t, maxval = s.static
        weights += [t, ref.pack(torch.tensor(maxval), carrier).item()]
    elif s.op == "affine":
        weights += list(s.static)
    return {"op": OP_CODES[s.op], "kh": kh, "kw": kw, "wx": wx, "wy": wy}


def compile_chain(stages, carrier: torch.dtype = torch.float32) -> ChainProgram:
    """Plan the kernel's steps for a chain of the ported stages in map and
    tap modes (others raise `NotImplementedError`)."""
    resolved = resolve_chain(stages)
    check_ported(resolved, "stencil_chain")
    ph_acc, pw_acc = chain_accumulated_halo(stages)
    last_map = max((k for k, r in enumerate(resolved) if r[1] == "map"), default=-1)

    def needed_after(k: int, band: int) -> bool:
        return any(r[1] == "map" or r[7] == band for r in resolved[k + 1 :])

    in_use = [True]  # slot 0 holds the input window

    def alloc() -> int:
        for i, used in enumerate(in_use):
            if not used:
                in_use[i] = True
                return i
        in_use.append(True)
        return len(in_use) - 1

    steps, weights = [], []
    bands = [0]  # slot of each live band
    rh, rw = ph_acc, pw_acc

    def step(**kw) -> dict:
        st = dict.fromkeys(_STEP_FIELDS, 0)
        st.update(kw)
        return st

    if last_map < 0:  # band 0 is the input itself, final from the start
        steps.append(step(op=_STORE, rh=rh, rw=rw, store=0))
    for k, (s, (op, mode, (hy, hx), *_rest, tap)) in enumerate(zip(stages, resolved)):
        params = stage_params(s, weights, carrier)
        for b in range(len(bands)) if mode == "map" else [tap]:
            src, dst = bands[b], alloc()
            tmp = alloc() if op in SEPARABLE_OPS else dst
            if mode == "map":
                store = b if k == last_map else -1
            else:
                store = len(bands) if k > last_map else -1
            steps.append(step(src=src, dst=dst, tmp=tmp, rh=rh, rw=rw, store=store, **params))
            if tmp != dst:
                in_use[tmp] = False
            if mode == "map":
                in_use[src] = False
                bands[b] = dst
            else:
                bands.append(dst)
        rh, rw = rh - hy, rw - hx
        for b, slot in enumerate(bands):
            if slot is not None and not needed_after(k, b):
                in_use[slot] = False
                bands[b] = None
    if len(steps) > MAX_STEPS or len(weights) > MAX_WEIGHTS:
        raise ValueError(
            f"stencil_chain: {len(steps)} steps / {len(weights)} weights exceed the "
            f"kernel's table ({MAX_STEPS} / {MAX_WEIGHTS})"
        )
    return ChainProgram(tuple(steps), tuple(weights), len(in_use), len(bands), (ph_acc, pw_acc))


def pick_tile(prog: ChainProgram, lc: LaunchConfig) -> tuple[int, int, int]:
    """Largest tile (halving from the configured one) whose window slots fit
    the block's shared-memory budget.  Returns (tile_h, tile_w, bytes)."""
    th, tw = lc.tile_rows, lc.tile_cols
    ph, pw = prog.halo
    while True:
        smem = prog.n_slots * (th + 2 * ph) * (tw + 2 * pw) * 4
        if smem + PROGRAM_BYTES <= lc.smem_budget:
            return th, tw, smem
        if th == tw == 1:
            raise ValueError(f"stencil_chain: halo {prog.halo} does not fit shared memory")
        th, tw = max(1, th // 2), max(1, tw // 2)


def chain_key(stages) -> tuple:
    return tuple(
        (s.op, s.static, s.tap, tuple((tuple(w.shape), tuple(w.reshape(-1).tolist())) for w in s.weights))
        for s in stages
    )


# (chain, carrier, device) -> (ChainProgram, its packed step table on the device)
_PROGRAMS: dict = {}


def _program(stages, carrier: torch.dtype, device: torch.device) -> tuple:
    """The chain's compiled program, and its step table copied to `device`
    once per chain (not once per launch)."""
    key = (chain_key(stages), carrier, str(device))
    hit = _PROGRAMS.get(key)
    if hit is None:
        prog = compile_chain(stages, carrier)
        table = torch.frombuffer(bytearray(prog.packed()), dtype=torch.uint8).to(device)
        hit = _PROGRAMS[key] = (prog, table)
    return hit


@functools.cache
def _launcher():
    lib = _build.library("stencil_chain")
    if lib.stencil_chain_program_bytes() != PROGRAM_BYTES:
        raise RuntimeError("stencil_chain: ChainProgram layout differs between C and Python")
    fn = lib.stencil_chain_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def stencil_chain_plain(planes: torch.Tensor, stages) -> tuple:
    """Plain PyTorch version of the kernel: `ref.chain_ref_planes`."""
    counters.PLAIN_CALLS["stencil_chain"] += 1
    return ref.chain_ref_planes(planes, tuple(stages))


def check_planes(name: str, planes: torch.Tensor) -> None:
    if not planes.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {planes.device}")
    if planes.dtype not in CARRIERS or planes.ndim != 3 or not planes.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous (N, H, W) uint8 or float32 planes, got "
            f"{planes.dtype} {tuple(planes.shape)}"
        )


def stencil_chain(planes: torch.Tensor, stages, lc: LaunchConfig = DEFAULT) -> tuple:
    """(N, H, W) u8 or f32 planes -> tuple of (N, H, W) output bands of the
    same dtype, in one launch.

    A CPU tensor runs the plain version; any other tensor launches the
    kernel or raises.  Every plane size launches, planes smaller than the
    chain's halo included."""
    stages = tuple(stages)
    if planes.device.type == "cpu":
        return stencil_chain_plain(planes, stages)
    fn = _launcher()
    check_planes("stencil_chain", planes)
    prog, dev_prog = _program(stages, planes.dtype, planes.device)
    th, tw, _ = pick_tile(prog, lc)
    N, H, W = planes.shape
    out = torch.empty((prog.n_bands, N, H, W), dtype=planes.dtype, device=planes.device)
    with torch.cuda.device(planes.device):
        err = fn(
            planes.data_ptr(),
            out.data_ptr(),
            dev_prog.data_ptr(),
            N,
            H,
            W,
            th,
            tw,
            prog.halo[0],
            prog.halo[1],
            prog.n_slots,
            lc.threads,
            int(planes.dtype == torch.uint8),
            _build.cuda_stream(planes.device),
        )
    _build.check(err, "stencil_chain")
    counters.LAUNCHES["stencil_chain"] += 1
    return tuple(out.unbind(0))
