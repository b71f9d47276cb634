"""Device-health ledger and plan circuit breaker for the sharded CV serve
(the counterpart of `repro.serve.health`, which imports no JAX; the port
keeps its own copy).

Two small state machines the sharded dispatcher
(`serve/shard_dispatch.py`) consults before it places work:

  * **DeviceHealthLedger**: per-device rolling failure / latency stats and
    a three-state lifecycle::

        healthy --(K consecutive failures, or one fatal failure)-->
        quarantined --(readmit_after dispatch rounds pass)-->
        probation --(first success)--> healthy
                  --(any failure)--> quarantined (cooldown restarts)

    A *fatal* failure (device loss, placement error) quarantines
    immediately.  Ordinary failures (a rung raised on the device) count
    only through the consecutive-failure rule, so a plan-level problem
    cannot take a good device out.

  * **CircuitBreaker**: keyed on ``(signature, bucket, rung)``; after
    `open_after` failures of one rung for one workload key the breaker
    opens and the dispatcher skips that rung to the next one (recording an
    event).  After `probe_after` skipped walks it goes half-open: the next
    walk tries the rung once; success closes it, failure re-opens it.  The
    final ladder rung is never skipped.

Both are pure counters, with no wall clock in any decision, so chaos runs
replay exactly from ``REPRO_TORCH_FAULT_SPEC``.  Every transition is
recorded as a `core.faultinject` degradation event (stage "health" /
"breaker", JAX's strings), which is how quarantines and short-circuits
reach a request's `Response.events`.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import torch

from ..core import faultinject

HEALTHY, PROBATION, QUARANTINED = "healthy", "probation", "quarantined"


def device_key(dev) -> str:
    """Stable string key for a fault domain: a `torch.device` keys as
    "<type>:<index>" ("cuda:0"; "cpu:0" for the CPU); anything else (the
    virtual devices tests use) keys as its str()."""
    if isinstance(dev, torch.device):
        return f"{dev.type}:{dev.index or 0}"
    return str(dev)


@dataclass
class DeviceStats:
    """Rolling health record of one fault domain."""
    key: str
    state: str = HEALTHY
    consecutive_failures: int = 0
    failures: int = 0
    successes: int = 0
    fatal_failures: int = 0
    quarantines: int = 0
    cooldown: int = 0                 # rounds left before probation
    latencies_s: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=32))
    last_reason: str = ""

    def mean_latency_s(self) -> float:
        return (sum(self.latencies_s) / len(self.latencies_s)
                if self.latencies_s else 0.0)


class DeviceHealthLedger:
    """Per-device rolling failure/latency stats with quarantine and
    probational re-admission (contract in the module docstring)."""

    def __init__(self, devices, *, quarantine_after: int = 2,
                 readmit_after: int = 3):
        if quarantine_after < 1 or readmit_after < 1:
            raise ValueError("quarantine_after and readmit_after must be >= 1")
        self.quarantine_after = int(quarantine_after)
        self.readmit_after = int(readmit_after)
        self._devices = list(devices)
        self._stats: dict[str, DeviceStats] = {
            device_key(d): DeviceStats(key=device_key(d)) for d in devices}
        if len(self._stats) != len(self._devices):
            raise ValueError("ledger devices must have distinct keys")

    # -- lookups -------------------------------------------------------------

    def stats(self, dev) -> DeviceStats:
        return self._stats[device_key(dev)]

    def devices(self) -> list:
        return list(self._devices)

    def healthy_devices(self) -> list:
        """Dispatchable devices (healthy + probation), best-first: fewest
        consecutive failures, then lowest rolling mean latency — the
        re-dispatch targets."""
        out = [d for d in self._devices
               if self._stats[device_key(d)].state != QUARANTINED]
        return sorted(out, key=lambda d: (
            self._stats[device_key(d)].consecutive_failures,
            self._stats[device_key(d)].mean_latency_s()))

    def pick(self, exclude=()) -> object | None:
        """Best healthy device not in `exclude` (by key), else None."""
        skip = {device_key(d) for d in exclude}
        for d in self.healthy_devices():
            if device_key(d) not in skip:
                return d
        return None

    def quarantined(self) -> list[str]:
        return [k for k, s in self._stats.items() if s.state == QUARANTINED]

    def snapshot(self) -> dict[str, dict]:
        """Machine-readable ledger view (tests / Response plumbing)."""
        return {k: {"state": s.state, "failures": s.failures,
                    "fatal_failures": s.fatal_failures,
                    "successes": s.successes,
                    "consecutive_failures": s.consecutive_failures,
                    "quarantines": s.quarantines,
                    "mean_latency_s": round(s.mean_latency_s(), 6),
                    "last_reason": s.last_reason}
                for k, s in self._stats.items()}

    # -- transitions ---------------------------------------------------------

    def record_success(self, dev, latency_s: float = 0.0) -> None:
        s = self.stats(dev)
        s.successes += 1
        s.consecutive_failures = 0
        s.latencies_s.append(float(latency_s))
        if s.state == PROBATION:
            s.state = HEALTHY
            faultinject.record_degradation(
                stage="health", from_plan=PROBATION, to_plan=HEALTHY,
                reason="probation shard succeeded: device re-admitted",
                detail=s.key)

    def record_failure(self, dev, *, reason: str = "",
                       fatal: bool = False) -> None:
        s = self.stats(dev)
        s.failures += 1
        s.consecutive_failures += 1
        s.fatal_failures += int(fatal)
        s.last_reason = str(reason)[:200]
        was = s.state
        if fatal or s.consecutive_failures >= self.quarantine_after \
                or was == PROBATION:
            s.state = QUARANTINED
            s.cooldown = self.readmit_after
            s.quarantines += 1
            faultinject.record_degradation(
                stage="health", from_plan=was, to_plan=QUARANTINED,
                reason=("fatal failure" if fatal else
                        f"{s.consecutive_failures} consecutive failures")
                + (f": {reason}" if reason else ""),
                detail=s.key, injected="injected" in str(reason))

    def tick(self) -> None:
        """One dispatch round passed: advance quarantine cooldowns; a
        device whose cooldown expires re-enters on probation (it gets one
        shard; see record_success/record_failure)."""
        for s in self._stats.values():
            if s.state == QUARANTINED:
                s.cooldown -= 1
                if s.cooldown <= 0:
                    s.state = PROBATION
                    s.consecutive_failures = 0
                    faultinject.record_degradation(
                        stage="health", from_plan=QUARANTINED,
                        to_plan=PROBATION,
                        reason=f"cooldown of {self.readmit_after} rounds "
                               "elapsed: probational re-admission",
                        detail=s.key)


@dataclass
class _BreakerEntry:
    failures: int = 0
    open: bool = False
    skips: int = 0
    opens: int = 0


class CircuitBreaker:
    """Per-(signature, bucket, rung) rung short-circuit (module docstring)."""

    def __init__(self, *, open_after: int = 2, probe_after: int = 3):
        if open_after < 1 or probe_after < 1:
            raise ValueError("open_after and probe_after must be >= 1")
        self.open_after = int(open_after)
        self.probe_after = int(probe_after)
        self._entries: dict[tuple, _BreakerEntry] = {}

    def _entry(self, key: tuple) -> _BreakerEntry:
        return self._entries.setdefault(tuple(key), _BreakerEntry())

    def allow(self, key: tuple) -> bool:
        """May this rung run for this key?  Open breakers skip the rung
        until `probe_after` skips have passed; then one half-open probe
        attempt is allowed through."""
        e = self._entry(key)
        if not e.open:
            return True
        if e.skips >= self.probe_after:
            return True                  # half-open: probe this walk
        e.skips += 1
        return False

    def record_failure(self, key: tuple) -> None:
        e = self._entry(key)
        e.failures += 1
        if not e.open and e.failures >= self.open_after:
            e.open, e.skips, e.opens = True, 0, e.opens + 1
            faultinject.record_degradation(
                stage="breaker", from_plan="closed", to_plan="open",
                reason=f"{e.failures} failures: rung short-circuited",
                detail="|".join(str(k) for k in key))
        elif e.open:
            e.skips = 0                  # failed probe: full cooldown again

    def record_success(self, key: tuple) -> None:
        e = self._entry(key)
        if e.open:
            faultinject.record_degradation(
                stage="breaker", from_plan="open", to_plan="closed",
                reason="probe succeeded: rung re-admitted",
                detail="|".join(str(k) for k in key))
        e.failures, e.open, e.skips = 0, False, 0

    def filter_rungs(self, base_key: tuple, rungs) -> tuple[tuple, list]:
        """(allowed rungs, skip events): drop open rungs — except the
        final one, which is always attemptable — recording one breaker
        skip event per dropped rung."""
        rungs = tuple(rungs)
        allowed, events = [], []
        for i, rung in enumerate(rungs):
            if i == len(rungs) - 1 or self.allow(tuple(base_key) + (rung,)):
                allowed.append(rung)
            else:
                nxt = rungs[i + 1]
                events.append(faultinject.record_degradation(
                    stage="breaker", from_plan=rung, to_plan=nxt,
                    reason="breaker open: rung skipped without attempt",
                    detail="|".join(str(k) for k in base_key)))
        return tuple(allowed), events

    def state(self, key: tuple) -> dict:
        e = self._entry(key)
        return {"failures": e.failures, "open": e.open, "skips": e.skips,
                "opens": e.opens}
