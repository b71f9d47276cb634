"""The port's device-health ledger, circuit breaker and fault runtime against
the JAX package's, on the CPU.

`serve/health.py` and `train/fault.py` import no JAX in either package, so
the same scripted calls go to each and everything observable must be equal:
  * `DeviceHealthLedger`: seeded sequences of `record_success`,
    `record_failure(fatal=)`, `tick`, `pick` and `healthy_devices` give the
    same `snapshot()`, `quarantined()`, `pick()` and event sequence;
  * `CircuitBreaker`: seeded sequences of `allow`, `record_failure`,
    `record_success` and `filter_rungs` give the same `state()`, allowed
    rungs and events;
  * `device_key` keys a `torch.device` as "<type>:<index>" and anything
    else as its str();
  * `StragglerWatchdog` flags the same steps with the same EWMA,
    `PreemptionGuard` sees a signal, `StepTimer` times a block.
"""

import os
import signal

import numpy as np
import pytest
import torch

from repro.core import faultinject as jfi
from repro.serve import health as jhealth
from repro.train import fault as jfault

from repro_torch.core import faultinject as tfi
from repro_torch.serve import health as thealth
from repro_torch.train import fault as tfault

EVENT_FIELDS = ("stage", "from_plan", "to_plan", "reason", "detail", "injected")
DEVICES = ["v0", "v1", "v2"]
LADDER = ("streaming", "tiled2d", "window", "ref")


@pytest.fixture(autouse=True)
def _clean_state():
    with tfi.inject(None), jfi.inject(None):
        tfi.clear_degradation_log()
        jfi.clear_degradation_log()
        yield
    tfi.clear_degradation_log()
    jfi.clear_degradation_log()


def events_of(evs) -> list:
    return [tuple(getattr(e, f) for f in EVENT_FIELDS) for e in evs]


def ledger_script(seed: int, n: int = 60) -> list:
    """A seeded sequence of ledger calls, the same for both packages."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        dev = DEVICES[int(rng.integers(len(DEVICES)))]
        kind = int(rng.integers(6))
        if kind == 0:
            ops.append(("success", dev, float(rng.integers(1, 50)) / 1000))
        elif kind in (1, 2):
            reason = "injected device_loss" if rng.random() < 0.3 else "rung failed"
            ops.append(("failure", dev, reason, bool(rng.random() < 0.25)))
        elif kind == 3:
            ops.append(("tick",))
        elif kind == 4:
            ops.append(("pick", tuple(d for d in DEVICES if rng.random() < 0.4)))
        else:
            ops.append(("healthy",))
    return ops


def run_ledger(mod, fi, script, **kw) -> tuple:
    led = mod.DeviceHealthLedger(DEVICES, **kw)
    seen = []
    with fi.collect_events() as evs:
        for op in script:
            if op[0] == "success":
                led.record_success(op[1], op[2])
            elif op[0] == "failure":
                led.record_failure(op[1], reason=op[2], fatal=op[3])
            elif op[0] == "tick":
                led.tick()
            elif op[0] == "pick":
                seen.append(("pick", led.pick(exclude=op[1])))
            else:
                seen.append(("healthy", led.healthy_devices()))
            seen.append(("snapshot", led.snapshot(), led.quarantined()))
    return seen, events_of(evs)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("quarantine_after,readmit_after", [(2, 3), (1, 1), (3, 2)])
def test_ledger_replays_jax(seed, quarantine_after, readmit_after):
    script = ledger_script(seed)
    kw = dict(quarantine_after=quarantine_after, readmit_after=readmit_after)
    got, got_ev = run_ledger(thealth, tfi, script, **kw)
    want, want_ev = run_ledger(jhealth, jfi, script, **kw)
    assert got == want
    assert got_ev == want_ev
    assert got_ev, "the script moved no device through a transition"


def test_ledger_lifecycle_and_refusals():
    """JAX's own lifecycle test, on the port: quarantine after two failures,
    probation after the cooldown, healthy after one success."""
    led = thealth.DeviceHealthLedger(["a", "b"], quarantine_after=2, readmit_after=3)
    led.record_failure("a", reason="rung failed")
    assert led.stats("a").state == "healthy"
    led.record_failure("a", reason="rung failed")
    assert led.quarantined() == ["a"] and led.healthy_devices() == ["b"]
    for _ in range(3):
        led.tick()
    assert led.stats("a").state == "probation" and "a" in led.healthy_devices()
    led.record_success("a", 0.01)
    assert led.stats("a").state == "healthy" and led.stats("a").consecutive_failures == 0
    for bad in ({"quarantine_after": 0}, {"readmit_after": 0}):
        with pytest.raises(ValueError):
            thealth.DeviceHealthLedger(["a"], **bad)
    with pytest.raises(ValueError, match="distinct keys"):
        thealth.DeviceHealthLedger(["a", "a"])


def breaker_script(seed: int, n: int = 80) -> list:
    rng = np.random.default_rng(seed)
    keys = [("sig", (32, 32)), ("sig", (64, 64))]
    ops = []
    for _ in range(n):
        base = keys[int(rng.integers(len(keys)))]
        rung = LADDER[int(rng.integers(len(LADDER)))]
        kind = rng.choice(4, p=[0.2, 0.4, 0.1, 0.3])  # failures often enough to open
        if kind == 0:
            ops.append(("allow", base + (rung,)))
        elif kind == 1:
            ops.append(("failure", base + (rung,)))
        elif kind == 2:
            ops.append(("success", base + (rung,)))
        else:
            start = int(rng.integers(len(LADDER)))
            ops.append(("filter", base, LADDER[start:]))
    return ops


def run_breaker(mod, fi, script, **kw) -> tuple:
    br = mod.CircuitBreaker(**kw)
    seen = []
    with fi.collect_events() as evs:
        for op in script:
            if op[0] == "allow":
                seen.append(("allow", br.allow(op[1])))
            elif op[0] == "failure":
                br.record_failure(op[1])
            elif op[0] == "success":
                br.record_success(op[1])
            else:
                rungs, skips = br.filter_rungs(op[1], op[2])
                seen.append(("filter", rungs, events_of(skips)))
            key = op[1] + (op[2][0],) if op[0] == "filter" else op[1]
            seen.append(("state", br.state(key)))
    return seen, events_of(evs)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("open_after,probe_after", [(2, 3), (1, 1), (3, 2)])
def test_breaker_replays_jax(seed, open_after, probe_after):
    script = breaker_script(seed)
    kw = dict(open_after=open_after, probe_after=probe_after)
    got, got_ev = run_breaker(thealth, tfi, script, **kw)
    want, want_ev = run_breaker(jhealth, jfi, script, **kw)
    assert got == want
    assert got_ev == want_ev
    assert any(e[0] == "breaker" for e in got_ev)


def test_breaker_never_drops_the_final_rung():
    br = thealth.CircuitBreaker(open_after=1, probe_after=99)
    base = ("sig", (32, 32))
    for rung in LADDER:
        br.record_failure(base + (rung,))
    rungs, skips = br.filter_rungs(base, LADDER)
    assert rungs == ("ref",)
    assert [(e.from_plan, e.to_plan) for e in skips] == [
        ("streaming", "tiled2d"), ("tiled2d", "window"), ("window", "ref")]


@pytest.mark.parametrize(
    "dev,key",
    [
        (torch.device("cuda", 0), "cuda:0"),
        (torch.device("cuda"), "cuda:0"),
        (torch.device("cuda", 3), "cuda:3"),
        (torch.device("cpu"), "cpu:0"),
        ("v0", "v0"),
        (7, "7"),
    ],
)
def test_device_key(dev, key):
    assert thealth.device_key(dev) == key
    if not isinstance(dev, torch.device):
        assert jhealth.device_key(dev) == key


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold,warmup", [(2.0, 5), (4.0, 2), (1.5, 0)])
def test_straggler_watchdog_replays_jax(seed, threshold, warmup):
    rng = np.random.default_rng(seed)
    steps = rng.gamma(2.0, 0.01, 40)
    steps[rng.integers(0, 40, 5)] *= 10  # a few stragglers
    alarms_t, alarms_j = [], []
    wt = tfault.StragglerWatchdog(threshold=threshold, warmup=warmup,
                                  on_alarm=lambda *a: alarms_t.append(a))
    wj = jfault.StragglerWatchdog(threshold=threshold, warmup=warmup,
                                  on_alarm=lambda *a: alarms_j.append(a))
    got = [wt.step(i, float(s)) for i, s in enumerate(steps)]
    want = [wj.step(i, float(s)) for i, s in enumerate(steps)]
    assert got == want and any(got)
    assert wt.alarms == wj.alarms == alarms_t == alarms_j
    assert wt.ewma == wj.ewma and wt.n == wj.n == 40


def test_preemption_guard_and_step_timer():
    guard = tfault.PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
    finally:
        guard.restore_handlers()
    with tfault.StepTimer() as t:
        sum(range(1000))
    assert t.seconds >= 0.0
