"""Measured mode choice and the plan table (the measured half of
`repro.core.autotune`; the model half, the planner, is
`kernels.stencil.plan`).

`measure_chain` times a chain's modes on the real input and caches the
winner per (chain signature, image shape, dtype, launch configuration,
device); ``fused_chain(mode=None)`` consults that in-process cache before
the fit rule.  The on-disk copy is a plan table, schema-versioned and
checksummed, whose damaged entries are quarantined to
``<cache>.corrupt-*`` with a `PlanTableWarning`.  It is written for
inspection (``python -m repro_torch.core.autotune --show-cache``) and read
back only when ``REPRO_TORCH_AUTOTUNE_CACHE_READ=1``, so test runs stay
deterministic.  The port's variables and default file
(``REPRO_TORCH_AUTOTUNE_CACHE``, ``~/.cache/repro_torch/chain_autotune.json``)
are its own.

On the card a measurement's candidates are only the kernels a chain can
take: ``"window"`` (`stencil_chain`), ``"tiled2d"``, and ``"streaming"``
where the fit rule says its full-width rings fit (`stencil_stream`);
``"ref"`` (the plain version) is a candidate on a CPU tensor only, and any
candidate's failure on the card raises.  The device in a key is the card's
name, so a table measured on one card never routes another.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time
import warnings

import torch

from . import faultinject
from .device import DEFAULT, LaunchConfig

CHAIN_MODES = ("streaming", "tiled2d", "window", "ref")
KERNEL_MODES = ("streaming", "tiled2d", "window")
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_READ_ENV = "REPRO_TORCH_AUTOTUNE_CACHE_READ"

_MODE_CACHE: dict[str, dict] = {}
_DISK_CACHE_LOADED = False


def cache_path() -> str:
    return os.environ.get(
        CACHE_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "chain_autotune.json"),
    )


def chain_signature(stages) -> str:
    """Stable plan signature: op + static params + tap + weight *shapes*
    (a mode choice does not depend on tap values); JAX's string for the
    same chain."""
    parts = []
    for s in stages:
        wshapes = "/".join("x".join(map(str, w.shape)) for w in getattr(s, "weights", ()))
        parts.append(
            f"{s.op}{tuple(getattr(s, 'static', ()))}t{getattr(s, 'tap', None)}w{wshapes}"
        )
    return "+".join(parts)


@functools.cache
def lc_tag(lc: LaunchConfig) -> str:
    """A launch configuration is part of a measurement's identity (JAX's
    `_vc_tag`)."""
    return (
        f"r{lc.tile_rows}c{lc.tile_cols}t{lc.threads}s{lc.smem_budget}q{lc.stream_rows}"
        f"w{lc.tile2d_cols}g{lc.row_segments}"
    )


@functools.cache
def _device_name(kind: str, index: int | None) -> str:
    if kind == "cuda":
        return torch.cuda.get_device_name(index if index is not None else torch.cuda.current_device())
    return kind


def device_tag(device) -> str:
    """The device part of a key (JAX's `jax.default_backend()`): the card's
    name on CUDA, else the device type."""
    dev = device if isinstance(device, torch.device) else torch.device(device or "cpu")
    return _device_name(dev.type, dev.index)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _cache_key(stages, shape, dtype, lc: LaunchConfig, device) -> str:
    """The plan-table key, memoised on the stage objects and the rest of
    the key's inputs: ``mode=None`` looks the table up on every call."""
    from ..kernels.stencil import exec_window

    shape = tuple(shape)
    return exec_window.by_stages(
        stages, ("autotune_key", shape, dtype, lc, str(device)),
        lambda: (f"{chain_signature(stages)}|{'x'.join(map(str, shape))}"
                 f"|{_dtype_name(dtype)}|{lc_tag(lc)}|{device_tag(device)}"),
    )


# -- the versioned plan table ------------------------------------------------------

PLAN_SCHEMA_VERSION = 1


class PlanTableWarning(UserWarning):
    """A plan-table file or entry was quarantined."""


class MeasureTimeout(RuntimeError):
    """measure_chain exceeded its deadline (or an injected timeout fired)."""


def _entry_checksum(key: str, core: dict) -> str:
    blob = json.dumps(
        {"key": key, "v": PLAN_SCHEMA_VERSION, "mode": core["mode"], "times": core["times"]},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def seal_entry(key: str, core: dict) -> dict:
    """Wrap a core ``{"mode", "times"}`` measurement for the plan table."""
    core = {"mode": core["mode"], "times": dict(core["times"])}
    return {**core, "v": PLAN_SCHEMA_VERSION, "sum": _entry_checksum(key, core)}


def _quarantine(path: str, payload: str, reason: str) -> None:
    """Move the offending bytes aside and warn; never raise."""
    dest = f"{path}.corrupt-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    try:
        with open(dest, "w") as f:
            f.write(payload)
    except OSError:
        dest = "<unwritable>"
    warnings.warn(f"plan table {path}: {reason}; quarantined to {dest}", PlanTableWarning,
                  stacklevel=3)


def load_plan_table(path: str | None = None, *, quarantine: bool = True) -> dict[str, dict]:
    """Read and validate the plan table: {key: {"mode", "times"}}.

    A damaged file (unreadable JSON, not an object) is quarantined whole; a
    damaged entry (schema version, checksum, missing fields) alone, and the
    valid rest is returned and written back.  ``quarantine=False``
    (inspection) drops invalid entries and touches no file."""
    path = path or cache_path()
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return {}
    text, _ = faultinject.corrupt_text(text, site=f"plan_table:{path}")
    try:
        raw = json.loads(text)
        if not isinstance(raw, dict):
            raise json.JSONDecodeError("top level is not an object", text, 0)
    except json.JSONDecodeError as e:
        if quarantine:
            _quarantine(path, text, f"unreadable JSON ({e.msg})")
            try:
                os.remove(path)
            except OSError:
                pass
            faultinject.record_degradation(stage="plan_table", from_plan=path, to_plan="empty",
                                           reason=f"unreadable JSON: {e.msg}")
        return {}
    good, bad = {}, {}
    for key, entry in raw.items():
        ok = (
            isinstance(entry, dict)
            and entry.get("v") == PLAN_SCHEMA_VERSION
            and isinstance(entry.get("mode"), str)
            and isinstance(entry.get("times"), dict)
        )
        if ok:
            core = {"mode": entry["mode"], "times": entry["times"]}
            ok = entry.get("sum") == _entry_checksum(key, core)
        if ok:
            good[key] = core
        else:
            bad[key] = entry
    if bad and quarantine:
        _quarantine(path, json.dumps(bad, indent=1, sort_keys=True),
                    f"{len(bad)} invalid entr{'y' if len(bad) == 1 else 'ies'} "
                    "(schema/checksum mismatch)")
        faultinject.record_degradation(stage="plan_table", from_plan=path,
                                       to_plan="valid-subset",
                                       reason=f"{len(bad)} entries quarantined",
                                       detail=";".join(list(bad)[:3]))
        save_plan_table(good, path)  # rewrite with the valid entries only
    return good


def save_plan_table(entries: dict[str, dict], path: str | None = None) -> bool:
    """Write sealed entries atomically; an `OSError` warns instead of raising."""
    path = path or cache_path()
    sealed = {k: seal_entry(k, v) for k, v in entries.items()}
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(sealed, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError as e:
        warnings.warn(f"plan table {path}: write failed ({e})", PlanTableWarning, stacklevel=2)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _load_disk_cache() -> None:
    global _DISK_CACHE_LOADED
    _DISK_CACHE_LOADED = True
    if os.environ.get(CACHE_READ_ENV) != "1":
        return
    for k, v in load_plan_table().items():
        _MODE_CACHE.setdefault(k, v)


def _lookup(key: str) -> dict | None:
    if not _DISK_CACHE_LOADED:
        _load_disk_cache()
    return _MODE_CACHE.get(key)


def cached_chain_entry(stages, shape, dtype, lc: LaunchConfig = DEFAULT,
                       device=None) -> dict | None:
    """The cached measurement ``{"mode", "times"}`` of this (chain, image
    shape, dtype, launch configuration, device), or None.  With nothing
    measured (and the disk copy read, or not asked for) no key is built."""
    if _DISK_CACHE_LOADED and not _MODE_CACHE:
        return None
    return _lookup(_cache_key(stages, shape, dtype, lc, device))


def cached_chain_mode(stages, shape, dtype, lc: LaunchConfig = DEFAULT,
                      device=None) -> str | None:
    """The measured winner of this (chain, image shape, dtype, launch
    configuration, device), or None."""
    hit = cached_chain_entry(stages, shape, dtype, lc, device)
    return hit["mode"] if hit else None


def clear_mode_cache() -> None:
    """Forget every in-process measurement; the disk copy is read again at
    the next lookup if ``REPRO_TORCH_AUTOTUNE_CACHE_READ=1``."""
    global _DISK_CACHE_LOADED
    _MODE_CACHE.clear()
    _DISK_CACHE_LOADED = False


def _is_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _best_s(fn, n: int, card: bool) -> float:
    """The fastest of `n` runs of `fn` on the host clock, the card
    synchronised around each."""
    best = float("inf")
    for _ in range(n):
        if card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if card:
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _warm(run, card: bool) -> Exception | None:
    """A candidate's first run, which also builds its kernel.  On the card
    any failure raises; on the CPU a `ValueError` (a misconfigured chain)
    raises and another failure is returned, and the candidate skipped."""
    if card:
        run()
        torch.cuda.synchronize()
        return None
    try:
        run()
    except ValueError:
        raise
    except Exception as e:
        return e
    return None


def chain_candidates(img: torch.Tensor, stages, lc: LaunchConfig = DEFAULT) -> tuple[str, ...]:
    """The modes `measure_chain` times by default: the kernel modes the
    chain can take (``"streaming"`` only where the fit rule says its rings
    fit), and on a CPU tensor ``"ref"`` too."""
    from ..kernels import ref
    from ..kernels.stencil import driver

    planes = ref.to_planes(img)
    fits = driver.streaming_fits(stages, planes.shape, planes.dtype, lc)
    modes = tuple(m for m in KERNEL_MODES if m != "streaming" or fits)
    return modes if _is_card(img) else modes + ("ref",)


def _check_modes(modes, allowed, card: bool, what: str) -> tuple[str, ...]:
    modes = tuple(modes)
    for m in modes:
        if m not in allowed:
            raise ValueError(f"{what}: unknown mode {m!r} (expected one of {allowed})")
        if card and m == "ref":
            raise ValueError(f"{what}: 'ref' (the plain version) is no candidate on the card")
    if not modes:
        raise ValueError(f"{what}: no candidate mode")
    return modes


def _record(key: str, times: dict, persist: bool) -> dict:
    winner = min(times, key=times.get)
    entry = {"mode": winner, "times": {k: round(v, 9) for k, v in times.items()}}
    _MODE_CACHE[key] = entry
    if persist:
        disk = load_plan_table()
        disk[key] = entry
        save_plan_table(disk)
    return entry


def measure_chain(img: torch.Tensor, stages, *, lc: LaunchConfig = DEFAULT, n: int = 3,
                  modes=None, persist: bool = True, deadline_s: float | None = None,
                  watchdog=None) -> dict:
    """Time a chain's modes on `img` and cache the winner, so that
    ``fused_chain(img, stages, mode=None)`` launches it.  Returns
    ``{"mode": winner, "times": {mode: best seconds}}`` (the fastest of `n`
    runs each, after one warm-up run that also builds the kernel; on the
    card `torch.cuda.synchronize` around each run).

    modes: None takes `chain_candidates`.  On a CUDA tensor ``"ref"`` may
        not be named (`ValueError`), and any candidate's failure raises;
        on the CPU a `ValueError` raises and another failure skips that
        candidate, as in the JAX package.
    deadline_s: once the measurement has taken this long, the candidates
        not yet timed are skipped (recorded as an event) and the winner is
        picked from those timed; the first always runs.
    watchdog: a `train.fault.StragglerWatchdog` that gets one ``.step(i,
        seconds)`` per timed candidate, from the candidate's start (its
        warm-up run included); a straggler is recorded as a
        ``measure_chain`` event from the mode to the same mode.
    persist: also write the entry into the plan table on disk."""
    from ..kernels import stencil

    if faultinject.should_fire("measure_timeout", site="measure_chain"):
        raise MeasureTimeout("injected measure_timeout before any candidate")
    stages = tuple(stages)
    card = _is_card(img)
    modes = chain_candidates(img, stages, lc) if modes is None else modes
    modes = _check_modes(modes, CHAIN_MODES, card, "measure_chain")
    key = _cache_key(stages, img.shape, img.dtype, lc, img.device)
    t_start = time.perf_counter()
    times, last_err, skipped = {}, None, []
    for i, mode in enumerate(modes):
        if i and deadline_s is not None and time.perf_counter() - t_start > deadline_s:
            skipped = list(modes[i:])
            break

        def run(m=mode):
            return stencil.fused_chain(img, stages, mode=m, lc=lc, ladder=())

        t_cand = time.perf_counter()
        err = _warm(run, card)
        if err is not None:
            last_err = err
            continue
        times[mode] = _best_s(run, n, card)
        if watchdog is not None and watchdog.step(i, time.perf_counter() - t_cand):
            faultinject.record_degradation(stage="measure_chain", from_plan=mode, to_plan=mode,
                                           reason="straggler candidate (watchdog alarm)",
                                           detail=key)
    if not times:
        if skipped:
            raise MeasureTimeout(
                f"measure_chain: deadline {deadline_s}s hit before any candidate ran ({skipped})"
            )
        raise RuntimeError("measure_chain: no candidate mode ran") from last_err
    if skipped:
        faultinject.record_degradation(stage="measure_chain", from_plan="+".join(skipped),
                                       to_plan="measured-subset",
                                       reason=f"deadline {deadline_s}s exceeded", detail=key)
    return _record(key, times, persist)


def measure_pyramid(img: torch.Tensor, chains, *, lc: LaunchConfig = DEFAULT, n: int = 3,
                    modes=None, persist: bool = True) -> list[dict]:
    """Warm the cache for a pyramid (`stencil.chained_launches`), one entry
    per link, each measured on that link's own input (the previous link's
    next-base band), so that ``mode=None`` finds every link's shrinking
    shape.  Returns the per-link entries.

    Unlike the JAX package, which routes links no larger than their halo to
    its plain version and records them as ``{"mode": "ref", "fallback":
    True}`` untimed, the port's `chained_launches` launches every link, so
    every link is measured."""
    from ..kernels import stencil

    chains = tuple(tuple(c) for c in chains)
    entries = []
    base = img
    for k, stages in enumerate(chains):
        entries.append(measure_chain(base, stages, lc=lc, n=n, modes=modes, persist=persist))
        if k < len(chains) - 1:
            stencil.validate_next_base(stages)
            base = stencil.fused_chain(base, stages, mode=entries[-1]["mode"], lc=lc)[-1]
    return entries


# -- the classifier tail ------------------------------------------------------------

CLASSIFY_MODES = ("fused", "ref")


def _classify_key(plan, shape, dtype) -> str:
    return (
        f"{plan.signature}|{'x'.join(map(str, shape))}|{_dtype_name(dtype)}"
        f"|{lc_tag(plan.lc)}|{device_tag(plan.centroids.device)}"
    )


def cached_classify_mode(plan, shape, dtype) -> str | None:
    """The measured winner of this (classifier tail, descriptor batch shape,
    dtype, launch configuration, device), or None."""
    hit = _lookup(_classify_key(plan, shape, dtype))
    return hit["mode"] if hit else None


def measure_classify(plan, descs: torch.Tensor, valids: torch.Tensor, *, n: int = 3,
                     modes=None, persist: bool = True) -> dict:
    """Time the classifier tail's modes (histograms + scores) on a
    descriptor batch and cache the winner, so that ``ClassifyPlan(mode=None)``
    takes it.  On a CUDA tensor the only candidate is ``"fused"`` (naming
    ``"ref"`` raises) and its failure raises; on the CPU both, a
    `ValueError` raising and another failure skipping the candidate.  Each
    mode runs without the plan's ladder, so a failing rung is never timed
    under another's name."""
    if faultinject.should_fire("measure_timeout", site="measure_classify"):
        raise MeasureTimeout("injected measure_timeout before any candidate")
    card = _is_card(descs)
    if modes is None:
        modes = ("fused",) if card else CLASSIFY_MODES
    modes = _check_modes(modes, CLASSIFY_MODES, card, "measure_classify")
    key = _classify_key(plan, descs.shape, descs.dtype)
    bare = dataclasses.replace(plan, ladder=None)
    times, last_err = {}, None
    for mode in modes:
        def tail(m=mode):
            return bare.scores(bare.histograms(descs, valids, mode=m), mode=m)

        err = _warm(tail, card)
        if err is not None:
            last_err = err
            continue
        times[mode] = _best_s(tail, n, card)
    if not times:
        raise RuntimeError("measure_classify: no candidate mode ran") from last_err
    return _record(key, times, persist)


def _show_cache() -> None:
    path = cache_path()
    print(f"# chain-mode autotune cache: {path} (plan-table schema v{PLAN_SCHEMA_VERSION})")
    disk = load_plan_table(quarantine=False)  # inspection: no file moves
    if not disk:
        print("(no persisted cache)")
    for k, v in sorted({**disk, **_MODE_CACHE}.items()):
        times = "  ".join(f"{m}={t:.4g}s" for m, t in v["times"].items())
        print(f"{k}\n  -> {v['mode']}   [{times}]")


if __name__ == "__main__":  # python -m repro_torch.core.autotune --show-cache
    import argparse

    ap = argparse.ArgumentParser(description="chain autotune cache tools")
    ap.add_argument("--show-cache", action="store_true", help="print the measured mode cache")
    if ap.parse_args().show_cache:
        _show_cache()
