"""Deterministic fault injection and the degradation-event log (the
counterpart of `repro.core.faultinject`).

Two halves, one module, importing nothing above ``core``:

  * **Fault registry**: named fault classes, each with a seeded firing
    schedule, installed with `configure` / `inject` or from the
    ``REPRO_TORCH_FAULT_SPEC`` environment variable (the port's own, so a
    process that imports both packages never arms the other's faults).
    Every firing decision is a function of (seed, kind, per-kind call
    counter) alone, through ``random.Random(f"{seed}:{kind}:{n}")``: the
    port fires on exactly the calls the JAX package fires on.

  * **Degradation-event log**: a bounded, process-wide record of every
    "planned path failed, took the next rung" decision (the ladder in
    `fused_chain` and `ClassifyPlan`, plan-table quarantine, a measurement
    cut by its deadline), as structured events that tests and
    `chip_smoke.py` assert on.

Fault taxonomy (`FAULT_KINDS`, JAX's names; the port's sites so far are
``lowering_error``, ``cache_corrupt``, ``measure_timeout`` and
``nan_input``):

  cache_corrupt   plan-table (autotune disk cache) text is mangled on read
  lowering_error  a kernel rung raises before it launches
  measure_timeout measure_chain raises MeasureTimeout before timing
  nan_input       float input frames get NaN/Inf poisoned at seeded spots
  bucket_miss     the serving engine's bucket lookup pretends not to fit
  device_loss     a data-axis device drops out mid-serve
  shard_oom       one shard's rung execution runs out of memory
  collective_timeout  the collective fan-out stalls past its deadline

Spec grammar::

    kind[:k=v[,k=v...]][;kind2[:...]...]

    e.g.  "lowering_error:p=0.5,seed=11;cache_corrupt;nan_input:count=2"

Per-kind knobs: ``p`` (firing probability per eligible call, default 1),
``count`` (max total firings, default unlimited), ``after`` (skip the
first N eligible calls), ``seed`` (stream seed, default 0).
"""

from __future__ import annotations

import collections
import contextvars
import os
import random
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

FAULT_KINDS = (
    "cache_corrupt",
    "lowering_error",
    "measure_timeout",
    "nan_input",
    "bucket_miss",
    "device_loss",
    "shard_oom",
    "collective_timeout",
)

ENV_VAR = "REPRO_TORCH_FAULT_SPEC"


class InjectedFault(RuntimeError):
    """Raised when a configured fault fires.  A RuntimeError, so the
    degradation ladder treats it like any other failure of a rung."""


@dataclass(frozen=True)
class FaultSpec:
    kind: str
    p: float = 1.0
    count: int | None = None
    after: int = 0
    seed: int = 0


def parse_spec(text: str | None) -> dict[str, FaultSpec]:
    """Parse the spec grammar into {kind: FaultSpec}.  Unknown kinds or
    malformed knobs raise `ValueError`."""
    specs: dict[str, FaultSpec] = {}
    if not text or not text.strip():
        return specs
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, knobs = part.partition(":")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one of {FAULT_KINDS}")
        kw: dict = {}
        if knobs.strip():
            for item in knobs.split(","):
                k, _, v = item.partition("=")
                k = k.strip()
                if k == "p":
                    kw["p"] = float(v)
                elif k in ("count", "after", "seed"):
                    kw[k] = int(v)
                else:
                    raise ValueError(f"unknown fault knob {k!r} in {part!r}")
        specs[kind] = FaultSpec(kind=kind, **kw)
    return specs


class FaultRegistry:
    """Active fault set and deterministic per-kind firing streams."""

    def __init__(self, specs: dict[str, FaultSpec]):
        self.specs = dict(specs)
        self._calls: collections.Counter = collections.Counter()
        self._fires: collections.Counter = collections.Counter()
        self.fired: list[tuple[str, str]] = []  # (kind, site) history

    def should_fire(self, kind: str, site: str = "") -> bool:
        """One eligible call of fault class `kind` at `site`: fire or not.
        The decision depends only on the spec and on how many eligible
        calls of this kind came before."""
        spec = self.specs.get(kind)
        if spec is None:
            return False
        n = self._calls[kind]
        self._calls[kind] += 1
        if n < spec.after:
            return False
        if spec.count is not None and self._fires[kind] >= spec.count:
            return False
        if spec.p < 1.0:
            # a str seed is hashed with sha512: stable across runs and versions
            if random.Random(f"{spec.seed}:{kind}:{n}").random() >= spec.p:
                return False
        self._fires[kind] += 1
        self.fired.append((kind, site))
        return True

    def fire_count(self, kind: str) -> int:
        return self._fires[kind]


# -- module state, installed from the environment at first use -----------------
_REGISTRY: FaultRegistry | None = None
_ENV_CONSULTED = False


def configure(spec: str | dict[str, FaultSpec] | None) -> FaultRegistry | None:
    """Install a fault registry (a spec string, a parsed dict, or None to
    clear) for the rest of the process, over any spec from the environment."""
    global _REGISTRY, _ENV_CONSULTED
    _ENV_CONSULTED = True
    if spec is None:
        _REGISTRY = None
    elif isinstance(spec, str):
        _REGISTRY = FaultRegistry(parse_spec(spec))
    else:
        _REGISTRY = FaultRegistry(dict(spec))
    return _REGISTRY


def registry() -> FaultRegistry | None:
    """The active registry, installed from ``REPRO_TORCH_FAULT_SPEC`` on
    first use."""
    global _REGISTRY, _ENV_CONSULTED
    if not _ENV_CONSULTED:
        _ENV_CONSULTED = True
        text = os.environ.get(ENV_VAR)
        if text:
            _REGISTRY = FaultRegistry(parse_spec(text))
    return _REGISTRY


class inject:
    """Run a block under a fault spec, then restore the registry before it:
    ``with faultinject.inject("lowering_error:count=1"): ...``;
    ``inject(None)`` runs the block fault-free."""

    def __init__(self, spec: str | dict[str, FaultSpec] | None):
        self._spec = spec

    def __enter__(self) -> FaultRegistry | None:
        self._saved = (_REGISTRY, _ENV_CONSULTED)
        return configure(self._spec)

    def __exit__(self, *exc):
        global _REGISTRY, _ENV_CONSULTED
        _REGISTRY, _ENV_CONSULTED = self._saved
        return False


def should_fire(kind: str, site: str = "") -> bool:
    reg = registry()
    return reg.should_fire(kind, site) if reg is not None else False


def maybe_raise(kind: str, site: str = "") -> None:
    """Raise `InjectedFault` if fault class `kind` fires at this call."""
    if should_fire(kind, site):
        raise InjectedFault(f"injected {kind} at {site or '<unknown>'}")


def poison(x: torch.Tensor, site: str = "") -> tuple[torch.Tensor, bool]:
    """nan_input fault: ``(tensor, fired)``, a copy with NaN and Inf at
    seeded spots when the fault fires (the spots JAX's `poison` picks for
    the same spec and firing).  Only non-empty floating tensors are
    eligible; others pass through without consuming a firing."""
    reg = registry()
    if reg is None or "nan_input" not in reg.specs:
        return x, False
    if not x.is_floating_point() or x.numel() == 0:
        return x, False
    if not reg.should_fire("nan_input", site):
        return x, False
    spec = reg.specs["nan_input"]
    gen = np.random.default_rng((spec.seed, reg.fire_count("nan_input")))
    n = x.numel()
    idx = torch.from_numpy(gen.choice(n, size=min(max(1, n // 997), n), replace=False))
    flat = x.reshape(-1).clone()
    flat[idx[0::2].to(x.device)] = float("nan")
    flat[idx[1::2].to(x.device)] = float("inf")
    return flat.reshape(x.shape), True


def corrupt_text(text: str, site: str = "") -> tuple[str, bool]:
    """cache_corrupt fault: mangle a text blob (a cut and a non-JSON splice
    in the middle) so that ``json.loads`` fails."""
    if not should_fire("cache_corrupt", site):
        return text, False
    mid = len(text) // 2
    return text[:mid] + "\x00<corrupted>" + text[mid + 1 :], True


# -- degradation events ----------------------------------------------------------


@dataclass(frozen=True)
class DegradationEvent:
    """One 'planned path failed, took another' decision."""

    stage: str  # "fused_chain" | "classify_hist" | "classify_score" | "plan_table" | "measure_chain"
    from_plan: str  # the plan that failed (rung name, file, ...)
    to_plan: str  # what ran instead
    reason: str  # short cause
    detail: str = ""  # shape / dtype / path / key
    injected: bool = False
    time_s: float = field(default=0.0, compare=False)


_DEG_LOG: collections.deque = collections.deque(maxlen=4096)
_DEG_COUNTS: collections.Counter = collections.Counter()
_DEG_LOCK = threading.Lock()  # guards the log and the counts
# scoped collectors (`collect_events`), context-local
_COLLECTORS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_deg_collectors", default=()
)


def record_degradation(
    *, stage: str, from_plan: str, to_plan: str, reason: str, detail: str = "",
    injected: bool = False
) -> DegradationEvent:
    ev = DegradationEvent(
        stage=stage,
        from_plan=str(from_plan),
        to_plan=str(to_plan),
        reason=str(reason)[:300],
        detail=str(detail)[:300],
        injected=injected,
        time_s=time.time(),
    )
    with _DEG_LOCK:
        _DEG_LOG.append(ev)
        _DEG_COUNTS[(ev.stage, ev.from_plan, ev.to_plan)] += 1
    for sink in _COLLECTORS.get():
        sink.append(ev)
    return ev


def degradation_log() -> list[DegradationEvent]:
    with _DEG_LOCK:
        return list(_DEG_LOG)


def degradation_counts() -> dict[tuple[str, str, str], int]:
    with _DEG_LOCK:
        return dict(_DEG_COUNTS)


def clear_degradation_log() -> None:
    with _DEG_LOCK:
        _DEG_LOG.clear()
        _DEG_COUNTS.clear()


class collect_events:
    """``with faultinject.collect_events() as evs: ...`` collects the events
    recorded inside the block, in this context (the process-wide log still
    gets every one).  Scopes nest."""

    def __enter__(self) -> list:
        self.events: list[DegradationEvent] = []
        self._token = _COLLECTORS.set(_COLLECTORS.get() + (self.events,))
        return self.events

    def __exit__(self, *exc):
        _COLLECTORS.reset(self._token)
        return False
