"""Fault-isolated sharded batch dispatch over the data axis (the
counterpart of `repro.serve.shard_dispatch`).

`ShardDispatcher` fans a canonical bucket batch out over the devices of a
CV mesh (`launch.mesh.make_cv_mesh`, one "data" axis) and treats **each
shard as an independent fault domain**: a shard that raises, or whose
output comes back poisoned, walks its own degradation ladder and, when a
whole ladder fails on a device or the device itself is lost, is
re-dispatched to a healthy device, while every other shard's result
stands.  Shards are contiguous slices of the batch axis
(`sharding.rules.cv_batch_split`), the per-image pipeline does no
cross-image math, and the padding rows that make the batch divide the
shard count are dropped on merge.

Two execution paths, fastest first:

  * **collective**: one pass that issues every shard's call on its own
    device before it brings any output back (JAX runs one `shard_map`
    launch here; on one device it is one call over the whole batch),
    taken when a mesh was given, every data-axis device is healthy and the
    batch fills the mesh.  A failure (including an injected
    ``collective_timeout``) costs the fall to the isolated path; the
    per-shard slices of a successful pass are still poison-checked one by
    one.
  * **isolated**: one placement and one ladder walk per shard on its own
    device (`.to(dev)` for a `torch.device`; a virtual device computes on
    the dispatcher's `device`).  Shards are dispatched in order, so every
    `core.faultinject` decision replays from ``REPRO_TORCH_FAULT_SPEC``.

Around the dispatch sit the robustness pieces of `serve/health.py`: the
device-health ledger (quarantine after K consecutive failures, at once on
a fatal loss, re-admission through probation) and the circuit breaker on
``(signature, bucket, rung)``.

Fault kinds exercised here (JAX's sites): ``device_loss`` (sticky: the
firing dispatch marks the device lost; later dispatches to it fail
without consuming firings), ``shard_oom`` (plan-level, absorbed by the
ladder), ``collective_timeout`` (collective path only).

Outputs come back as host numpy arrays.  As the engine does, a
dispatcher on the card (a CUDA compute device or mesh) defaults to the
kernel rungs, ``("streaming", "tiled2d", "window")``, and refuses a ladder
in which ``"ref"`` follows another rung (`ValueError`); on the CPU its
default is JAX's whole ladder.  A rung that cannot plan a shard's shape
(`stencil.PlanOverBudget`) moves to the next rung with an event, as in
the engine; every other `ValueError` propagates.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import faultinject
from ..core.device import resolve_device
from ..kernels.stencil import PlanOverBudget
from ..kernels.stencil.ladder import DEGRADATION_LADDER, MODES, resolve_rungs
from ..sharding import rules
from .health import CircuitBreaker, DeviceHealthLedger, device_key

__all__ = ["ShardDispatcher", "DispatchReport", "ShardResult", "DeviceLost", "PoisonedShard",
           "KERNEL_LADDER", "check_ladder"]

# the degradation ladder without its plain-version floor: the default on the card
KERNEL_LADDER = tuple(m for m in DEGRADATION_LADDER if m != "ref")


def check_ladder(ladder, card: bool, what: str) -> tuple:
    """A serving ladder's rungs, validated: each one of `MODES`, at least
    one, and on the card no ``"ref"`` after another rung (the plain version
    runs on the card only as the caller's one explicit rung)."""
    ladder = tuple(ladder)
    if not ladder:
        raise ValueError("ladder must have at least one rung")
    for rung in ladder:
        if rung not in MODES:
            raise ValueError(f"unknown ladder rung {rung!r}")
    if card and "ref" in ladder[1:]:
        raise ValueError(
            f"{what}: ladder {ladder} moves to 'ref' (the plain version) on the card; "
            "there a failing kernel raises, and the plain version runs only as ladder=('ref',)")
    return ladder


def _to_host(out: dict) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


class DeviceLost(RuntimeError):
    """Device-attributed failure: an injected device_loss, a sticky
    already-lost device, or a real placement error.  Handled by
    re-dispatching the shard, never by degrading the plan."""

    def __init__(self, msg: str, *, injected: bool = False):
        super().__init__(msg)
        self.injected = injected


class PoisonedShard(RuntimeError):
    """A shard's output came back with non-finite values: treated as a
    rung failure (retried down the ladder), not a device failure."""


@dataclass
class ShardResult:
    shard: int
    ok: bool
    value: dict | None = None        # {"desc": ..., "valid": ...} np arrays
    plan: str | None = None          # the rung that produced the answer
    device: str | None = None        # device_key of the serving device
    redispatches: int = 0
    collective: bool = False         # served by the collective pass
    latency_s: float = 0.0
    error: str | None = None
    events: list = field(default_factory=list)


@dataclass
class DispatchReport:
    """One dispatched batch: per-shard outcomes + merge helpers."""
    batch: int                       # original (unpadded) batch size
    n_shards: int
    shard_size: int                  # padded rows per shard
    shards: list                     # n_shards ShardResults, in shard order
    events: list = field(default_factory=list)   # dispatch-level events

    def shard_of(self, index: int) -> int:
        """Shard that served request `index` (its batch-axis position)."""
        return min(index // self.shard_size, self.n_shards - 1)

    def result_of(self, index: int):
        """(ShardResult, row-within-shard) for one request."""
        s = self.shard_of(index)
        return self.shards[s], index - s * self.shard_size

    def merged(self) -> dict | None:
        """Batch outputs re-assembled in shard order, padding dropped;
        None when any shard failed (per-request plumbing must be used)."""
        if any(not s.ok for s in self.shards):
            return None
        keys = self.shards[0].value.keys()
        return {k: np.concatenate([s.value[k] for s in self.shards])
                [:self.batch] for k in keys}

    def ladder_events(self) -> list:
        return self.events + [e for s in self.shards for e in s.events]


def _poisoned_fields(out: dict) -> list[str]:
    return [k for k, v in out.items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            and not np.isfinite(v).all()]


class ShardDispatcher:
    """Sharded batch dispatcher with per-shard fault domains (module
    docstring).  Build from a mesh (real devices) or from explicit
    `devices=` handles: any hashables; those that are not a `torch.device`
    act as virtual fault domains that all compute on `device` (tests use
    strings), with every ledger / breaker / re-dispatch rule the same.

    device: the compute device of virtual fault domains (None: the first
        real device given, else "cuda", raising without one)."""

    def __init__(self, mesh=None, *, devices=None, ladder=None,
                 health: DeviceHealthLedger | None = None,
                 breaker: CircuitBreaker | None = None,
                 collective: bool = True, max_redispatch: int | None = None,
                 quarantine_after: int = 2, readmit_after: int = 3,
                 open_after: int = 2, probe_after: int = 3, device=None):
        if devices is None:
            if mesh is None:
                from ..launch.mesh import make_cv_mesh
                mesh = make_cv_mesh(device=device)
            devices = rules.cv_data_devices(mesh)
        elif mesh is not None:
            raise ValueError("pass mesh= OR devices=, not both (explicit "
                             "devices have no mesh layout)")
        self.mesh = mesh
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("ShardDispatcher needs at least one device")
        self.n_shards = len(self.devices)
        real = [d for d in self.devices if isinstance(d, torch.device)]
        self.device = resolve_device(device if device is not None
                                     else (real[0] if real else None))
        self.card = self.device.type == "cuda" or any(d.type == "cuda" for d in real)
        if ladder is None:
            ladder = KERNEL_LADDER if self.card else DEGRADATION_LADDER
        self.ladder = check_ladder(ladder, self.card, "ShardDispatcher")
        self.collective = bool(collective) and mesh is not None
        self.max_redispatch = (self.n_shards if max_redispatch is None
                               else int(max_redispatch))
        self.health = health if health is not None else DeviceHealthLedger(
            self.devices, quarantine_after=quarantine_after,
            readmit_after=readmit_after)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            open_after=open_after, probe_after=probe_after)
        self._lost: set[str] = set()
        self.stats = {"dispatches": 0, "collective_batches": 0,
                      "isolated_shards": 0, "redispatches": 0,
                      "poisoned_shards": 0, "failed_shards": 0}

    # -- fault domains -------------------------------------------------------

    def _check_device(self, dev) -> None:
        """device_loss fault site + sticky lost-device guard.  The firing
        decision is per dispatch attempt (counter-keyed, deterministic);
        once a device is lost every later dispatch to it raises without
        consuming another firing."""
        if dev is None:
            return
        key = device_key(dev)
        if key in self._lost:
            raise DeviceLost(f"device {key} is lost (injected device_loss)",
                             injected=True)
        if faultinject.should_fire("device_loss", site=f"device:{key}"):
            self._lost.add(key)
            raise DeviceLost(f"injected device_loss at {key}", injected=True)

    def lost_devices(self) -> list[str]:
        return sorted(self._lost)

    def _place_and_run(self, shard_np, dev, fn, rung: str) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(shard_np))
        if isinstance(dev, torch.device):
            try:
                x = x.to(dev)
            except Exception as e:
                raise DeviceLost(
                    f"placement on {device_key(dev)} failed: "
                    f"{type(e).__name__}: {e}") from e
        else:
            x = x.to(self.device)
        return _to_host(fn(x, rung))

    # -- collective fast path ------------------------------------------------

    def _collective_run(self, shards, fn, rung: str) -> dict:
        """Every shard's call issued on its own device, then every output
        brought back to the host and joined in shard order."""
        outs = [fn(torch.from_numpy(np.ascontiguousarray(s)).to(d), rung)
                for s, d in zip(shards, self.devices)]
        host = [_to_host(o) for o in outs]
        return {k: np.concatenate([h[k] for h in host]) for k in host[0]}

    def _collective_eligible(self, n: int) -> bool:
        if not (self.collective and n == self.n_shards):
            return False
        return all(device_key(d) not in self._lost
                   and self.health.stats(d).state == "healthy"
                   for d in self.devices)

    # -- isolated path -------------------------------------------------------

    def _run_isolated(self, idx: int, shard_np, fn, rungs, base_key,
                      dev) -> ShardResult:
        """One shard's full fault-domain walk: ladder on its device,
        device losses re-dispatch, ladder exhaustion re-dispatches, the
        last healthy option failing returns ok=False.  Wrapped in a
        scoped event collector so this shard's events cannot interleave
        with another shard's."""
        with faultinject.collect_events() as events:
            tried: list = []
            redispatches, ri = 0, 0
            while True:
                rung = rungs[ri]
                last = ri == len(rungs) - 1
                key = tuple(base_key) + (rung,)
                try:
                    self._check_device(dev)
                    faultinject.maybe_raise(
                        "shard_oom", site=f"shard{idx}:{rung}")
                    t0 = time.monotonic()
                    out = self._place_and_run(shard_np, dev, fn, rung)
                    dt = time.monotonic() - t0
                    bad = _poisoned_fields(out)
                    if bad and not last:
                        self.stats["poisoned_shards"] += 1
                        raise PoisonedShard(
                            f"non-finite values in {','.join(bad)}")
                    if bad:       # floor rung: accept, on the record
                        faultinject.record_degradation(
                            stage="dispatch", from_plan=rung, to_plan=rung,
                            reason=f"floor rung output poisoned "
                                   f"({','.join(bad)}): accepted with event",
                            detail=f"shard {idx}")
                    self.health.record_success(dev, dt)
                    self.breaker.record_success(key)
                    return ShardResult(
                        shard=idx, ok=True, value=out, plan=rung,
                        device=device_key(dev), redispatches=redispatches,
                        latency_s=dt, events=events)
                except PlanOverBudget as e:
                    if last:
                        raise
                    # the rung cannot plan this shard's shape: the next one
                    faultinject.record_degradation(
                        stage="dispatch", from_plan=rung,
                        to_plan=rungs[ri + 1],
                        reason=f"rung cannot plan this shard: {e}",
                        detail=f"shard {idx}")
                    ri += 1
                except ValueError:
                    raise     # misconfiguration: no fault domain masks it
                except DeviceLost as e:
                    self.health.record_failure(dev, reason=str(e),
                                               fatal=True)
                    tried.append(dev)
                    nxt = self.health.pick(exclude=tried)
                    if nxt is None or redispatches >= self.max_redispatch:
                        self.stats["failed_shards"] += 1
                        return ShardResult(
                            shard=idx, ok=False, device=device_key(dev),
                            redispatches=redispatches, events=events,
                            error=f"device_lost_no_healthy: {e}")
                    faultinject.record_degradation(
                        stage="dispatch", from_plan=device_key(dev),
                        to_plan=device_key(nxt),
                        reason="device lost: shard re-dispatched",
                        detail=f"shard {idx}", injected=e.injected)
                    dev = nxt                       # same rung, new device
                    redispatches += 1
                    self.stats["redispatches"] += 1
                except Exception as e:
                    self.breaker.record_failure(key)
                    injected = isinstance(e, faultinject.InjectedFault)
                    if not last:
                        faultinject.record_degradation(
                            stage="dispatch", from_plan=rung,
                            to_plan=rungs[ri + 1],
                            reason=f"shard rung failed: "
                                   f"{type(e).__name__}: {e}",
                            detail=f"shard {idx}", injected=injected)
                        ri += 1
                        continue
                    # whole ladder failed here: the device is suspect too
                    self.health.record_failure(
                        dev, reason=f"{type(e).__name__}: {e}")
                    tried.append(dev)
                    nxt = self.health.pick(exclude=tried)
                    if nxt is None or redispatches >= self.max_redispatch:
                        self.stats["failed_shards"] += 1
                        return ShardResult(
                            shard=idx, ok=False, device=device_key(dev),
                            redispatches=redispatches, events=events,
                            error=f"ladder_exhausted: "
                                  f"{type(e).__name__}: {e}")
                    faultinject.record_degradation(
                        stage="dispatch", from_plan=device_key(dev),
                        to_plan=device_key(nxt),
                        reason="ladder exhausted on device: shard "
                               "re-dispatched", detail=f"shard {idx}",
                        injected=injected)
                    dev, ri = nxt, 0                # fresh ladder walk
                    redispatches += 1
                    self.stats["redispatches"] += 1

    # -- public API ----------------------------------------------------------

    def dispatch(self, batch, fn, *, signature: str = "",
                 bucket=None, mode: str | None = None) -> DispatchReport:
        """Fan one canonical batch out over the data axis.

        batch: (B, H, W[, C]) canonical numpy batch (already admitted,
            bucket-padded — the engine's groups).
        fn(x, rung) -> dict of batch-leading tensors (x a tensor on the
            shard's device): the per-rung batch computation
            (`CvEngine._batch_fn`).  It must not install its own ladder:
            the dispatcher owns degradation.
        signature/bucket: the workload identity half of the breaker key.
        mode: explicit start rung (default: the ladder's first rung); the
            walk is `stencil.resolve_rungs(mode, ladder)`.

        Returns a DispatchReport; raises only ValueError (caller bug).
        Requests of a shard whose every option failed come back with that
        ShardResult's ok=False — the rest of the batch stands."""
        batch = np.asarray(batch)
        B = batch.shape[0]
        if B == 0:
            raise ValueError("dispatch: empty batch")
        self.stats["dispatches"] += 1
        self.health.tick()
        n = min(self.n_shards, B)
        shard_np, per = rules.cv_batch_split(batch, n)
        base_key = (signature, tuple(bucket) if bucket else None)
        walk = resolve_rungs(mode if mode is not None else self.ladder[0],
                             self.ladder, card=self.card)

        results: list[ShardResult | None] = [None] * n
        pending = list(range(n))
        report_events: list = []

        # -- collective fast path: every shard issued before any is awaited
        if self._collective_eligible(n):
            rungs, skip_evs = self.breaker.filter_rungs(base_key, walk)
            rung0 = rungs[0]
            with faultinject.collect_events() as cev:
                try:
                    for d in self.devices:
                        self._check_device(d)
                    faultinject.maybe_raise(
                        "collective_timeout",
                        site=f"collective:{signature}")
                    t0 = time.monotonic()
                    out = self._collective_run(shard_np, fn, rung0)
                    dt = time.monotonic() - t0
                    pending = []
                    for i in range(n):
                        sl = {k: v[i * per:(i + 1) * per]
                              for k, v in out.items()}
                        bad = _poisoned_fields(sl)
                        if bad:
                            self.stats["poisoned_shards"] += 1
                            self.breaker.record_failure(
                                tuple(base_key) + (rung0,))
                            faultinject.record_degradation(
                                stage="dispatch", from_plan="collective",
                                to_plan="isolated",
                                reason=f"shard output poisoned "
                                       f"({','.join(bad)}): isolated retry",
                                detail=f"shard {i}")
                            pending.append(i)
                            continue
                        self.health.record_success(self.devices[i], dt)
                        results[i] = ShardResult(
                            shard=i, ok=True, value=sl, plan=rung0,
                            device=device_key(self.devices[i]),
                            collective=True, latency_s=dt)
                    if len(pending) < n:
                        self.breaker.record_success(
                            tuple(base_key) + (rung0,))
                        self.stats["collective_batches"] += 1
                except ValueError as e:
                    if not isinstance(e, PlanOverBudget):
                        raise
                    faultinject.record_degradation(
                        stage="dispatch", from_plan="collective",
                        to_plan="isolated",
                        reason=f"rung {rung0} cannot plan the batch: {e}",
                        detail=f"{signature}|{n} shards")
                    pending = list(range(n))
                except Exception as e:
                    faultinject.record_degradation(
                        stage="dispatch", from_plan="collective",
                        to_plan="isolated",
                        reason=f"collective fan-out failed: "
                               f"{type(e).__name__}: {e}",
                        detail=f"{signature}|{n} shards",
                        injected=isinstance(e, faultinject.InjectedFault))
                    pending = list(range(n))
            report_events.extend(skip_evs)
            report_events.extend(
                ev for ev in cev if ev not in report_events)

        # -- isolated fault domains: sequential dispatch (deterministic
        # fault replay)
        if pending:
            healthy = self.health.healthy_devices()
            for i in pending:
                rungs, skip_evs = self.breaker.filter_rungs(base_key, walk)
                dev = (healthy[i % len(healthy)] if healthy
                       else self.devices[i % self.n_shards])
                results[i] = self._run_isolated(
                    i, shard_np[i], fn, rungs, base_key, dev)
                results[i].events = list(skip_evs) + results[i].events
                self.stats["isolated_shards"] += 1
                healthy = self.health.healthy_devices()

        return DispatchReport(batch=B, n_shards=n, shard_size=per,
                              shards=results, events=report_events)
