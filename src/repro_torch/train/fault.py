"""Fault-tolerance runtime pieces: preemption handling and a straggler
watchdog (a copy of `repro.train.fault`, which imports no JAX; the port
imports nothing of the JAX package).

  * PreemptionGuard: SIGTERM / SIGINT flips a flag; a loop checkpoints and
    exits cleanly at its next step boundary.
  * StragglerWatchdog: EWMA of per-step wall time; a step slower than
    `threshold` x the EWMA raises an alarm with a pluggable action.
    `core.autotune.measure_chain` feeds it one step per candidate and
    `serve.cv_engine.CvEngine.warm` passes the engine's own.
  * StepTimer: a `with` block's wall time.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore_handlers(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


@dataclass
class StragglerWatchdog:
    threshold: float = 2.0  # alarm if a step > threshold * EWMA
    alpha: float = 0.1  # EWMA smoothing
    warmup: int = 5  # steps that only feed the EWMA (builds, first calls)
    on_alarm: Callable[[int, float, float], None] | None = None
    ewma: float = 0.0
    n: int = 0
    alarms: list = field(default_factory=list)

    def step(self, step_idx: int, seconds: float) -> bool:
        """Record one step; returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            self.ewma = (seconds if self.ewma == 0
                         else (1 - self.alpha) * self.ewma + self.alpha * seconds)
            return False
        is_slow = seconds > self.threshold * self.ewma
        if is_slow:
            self.alarms.append((step_idx, seconds, self.ewma))
            if self.on_alarm:
                self.on_alarm(step_idx, seconds, self.ewma)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_slow


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
