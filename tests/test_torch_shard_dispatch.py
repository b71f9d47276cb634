"""The port's sharded dispatcher, CV mesh and batch rules against the JAX
package's, on the CPU.

Both packages' `ShardDispatcher`s run over the virtual devices ["v0", "v1",
"v2"] with a stub ``fn(x, rung)`` that does the same arithmetic on each side
(doubles the batch; raises on chosen rungs; returns NaN where a pixel holds
the sentinel, on a chosen rung).  Each scenario drives a sequence of
dispatches of several batch sizes under one fault spec, and each shard's
``ok``, ``plan``, ``device``, ``redispatches``, ``collective`` and error,
the merged output, the dispatcher's stats, lost devices and ledger, and the
event sequence must be equal.  The collective path runs over the port's
one-device CPU mesh against JAX's ``make_cv_mesh(data=1)``.  On the card
(a stubbed device check) the default ladder is the kernel rungs and a
ladder that moves to "ref" raises.  Both modules read a clock that ticks
1 ms a reading (`TickClock`), so both ledgers rank devices alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faultinject as jfi
from repro.launch import mesh as jmesh
from repro.serve import shard_dispatch as jsd
from repro.sharding import rules as jrules

from repro_torch.core import faultinject as tfi
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import shard_dispatch as tsd
from repro_torch.sharding import rules as trules

EVENT_FIELDS = ("stage", "from_plan", "to_plan", "reason", "detail", "injected")
SHARD_FIELDS = ("shard", "ok", "plan", "device", "redispatches", "collective", "error")
SENTINEL = -7.0
BATCHES = (7, 3, 5, 1, 6, 4)  # a dispatch each, in this order


class TickClock:
    """A `time` stand-in whose clock advances 1 ms a reading: the ledger
    ranks healthy devices by their mean latency, so both packages must read
    the same latencies to pick the same devices."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setattr(tsd, "time", TickClock())
    monkeypatch.setattr(jsd, "time", TickClock())
    monkeypatch.delenv(tfi.ENV_VAR, raising=False)
    monkeypatch.delenv(jfi.ENV_VAR, raising=False)
    with tfi.inject(None), jfi.inject(None):
        tfi.clear_degradation_log()
        jfi.clear_degradation_log()
        yield
    tfi.clear_degradation_log()
    jfi.clear_degradation_log()


def stub(side: str, fail_rungs=(), poison_rung=None):
    """The same arithmetic on both sides: y = 2x, NaN where x holds the
    sentinel at `poison_rung`, RuntimeError on `fail_rungs`."""

    def fn(x, rung):
        if rung in fail_rungs:
            raise RuntimeError(f"boom at {rung}")
        if side == "jax":
            y = jnp.asarray(x) * 2
            if rung == poison_rung:
                y = jnp.where(y == 2 * SENTINEL, jnp.nan, y)
        else:
            y = x * 2
            if rung == poison_rung:
                y = torch.where(y == 2 * SENTINEL, torch.full_like(y, float("nan")), y)
        return {"y": y}

    return fn


def batches(poison_batch: int | None = None) -> list:
    rng = np.random.default_rng(5)
    out = []
    for i, b in enumerate(BATCHES):
        x = rng.random((b, 4, 4), dtype=np.float32)
        if i == poison_batch:
            x[b // 2, 1, 1] = SENTINEL  # the middle request's shard
        out.append(x)
    return out


def events_of(evs) -> list:
    return [tuple(getattr(e, f) for f in EVENT_FIELDS) for e in evs]


def run(side: str, spec, fn, work, **kw) -> dict:
    fi, sd = (jfi, jsd) if side == "jax" else (tfi, tsd)
    if side == "torch":
        kw.setdefault("device", "cpu")
    disp = sd.ShardDispatcher(**kw)
    reports = []
    with fi.inject(spec), fi.collect_events() as evs:
        for x in work:
            r = disp.dispatch(x, fn, signature="cv:extract:kp8:oct1:pre0", bucket=(4, 4))
            merged = r.merged()
            reports.append({
                "shape": (r.batch, r.n_shards, r.shard_size),
                "shards": [tuple(getattr(s, f) for f in SHARD_FIELDS) for s in r.shards],
                "shard_events": [events_of(s.events) for s in r.shards],
                "report_events": events_of(r.events),
                "merged": None if merged is None else merged["y"],
                "owner": [r.shard_of(k) for k in range(r.batch)],
            })
    return {"reports": reports, "events": events_of(evs), "stats": dict(disp.stats),
            "lost": disp.lost_devices(), "ledger": disp.health.snapshot()}


def assert_same(got: dict, want: dict) -> None:
    for g, w in zip(got["reports"], want["reports"], strict=True):
        merged_g, merged_w = g.pop("merged"), w.pop("merged")
        assert g == w
        if merged_w is None:
            assert merged_g is None
        else:
            np.testing.assert_array_equal(merged_g, merged_w)
    for k in ("events", "stats", "lost", "ledger"):
        assert got[k] == want[k], k


SCENARIOS = {
    "fault-free": (None, {}, None, {}),
    "shard_oom": ("shard_oom:count=1", {}, None, {}),
    "shard_oom x3": ("shard_oom:count=3", {}, None, {}),
    "device_loss": ("device_loss:count=1", {}, None, {}),
    "every device lost": ("device_loss", {}, None, {}),
    "collective_timeout": ("collective_timeout:count=1", {}, None, {}),
    "poisoned shard": (None, {"poison_rung": "streaming"}, 0, {}),
    "poisoned at the floor": (None, {"poison_rung": "ref"}, 0, {"ladder": ("ref",)}),
    "rung raises, breaker opens": (None, {"fail_rungs": ("streaming",)}, None,
                                   {"open_after": 2, "probe_after": 2}),
    "ladder exhausted": (None, {"fail_rungs": ("window", "ref")}, None,
                         {"ladder": ("window", "ref"), "max_redispatch": 1}),
    "loss and oom, seeded": ("device_loss:p=0.3,seed=3;shard_oom:p=0.4,seed=1", {}, None, {}),
}


@pytest.mark.parametrize("name", SCENARIOS)
def test_dispatcher_replays_jax(name):
    spec, stub_kw, poison_batch, kw = SCENARIOS[name]
    work = batches(poison_batch)
    devices = ["v0", "v1", "v2"]
    got = run("torch", spec, stub("torch", **stub_kw), work, devices=devices, **kw)
    want = run("jax", spec, stub("jax", **stub_kw), work, devices=devices, **kw)
    assert_same(got, want)
    if name == "fault-free":
        for r, x in zip(got["reports"], work):
            assert all(s[1] and s[2] == "streaming" for s in r["shards"])
    if (spec is not None or stub_kw) and name != "collective_timeout":
        # (without a mesh there is no collective pass for the fault to hit)
        assert got["events"], "the scenario recorded no event"


@pytest.mark.parametrize("name", ["fault-free", "collective_timeout", "device_loss",
                                  "poisoned shard", "rung raises, breaker opens"])
def test_collective_path_on_a_one_device_mesh_replays_jax(name):
    spec, stub_kw, poison_batch, kw = SCENARIOS[name]
    work = batches(poison_batch)
    got = run("torch", spec, stub("torch", **stub_kw), work,
              mesh=tmesh.make_cv_mesh(device="cpu"), **kw)
    want = run("jax", spec, stub("jax", **stub_kw), work, mesh=jmesh.make_cv_mesh(data=1), **kw)
    assert_same(got, want)
    if name == "fault-free":
        assert got["stats"]["collective_batches"] == len(BATCHES)
        assert all(s[5] for r in got["reports"] for s in r["shards"])


def test_cv_mesh_and_rules():
    mesh = tmesh.make_cv_mesh(device="cpu")
    assert mesh.axis_names == ("data",) and mesh.devices == (torch.device("cpu"),)
    assert trules.cv_data_devices(mesh) == [torch.device("cpu")]
    bad = tmesh.CvMesh(devices=(torch.device("cpu"),), axis_names=("model",))
    jbad = jmesh.make_mesh((1,), ("model",))
    with pytest.raises(ValueError) as got:
        trules.cv_data_devices(bad)
    with pytest.raises(ValueError) as want:
        jrules.cv_data_devices(jbad)
    assert str(got.value) == str(want.value).replace("('model',)", "('model',)")
    x = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    shards, per = trules.cv_batch_split(x, 3)
    assert per == 3 and [s.shape[0] for s in shards] == [3, 3, 3]
    np.testing.assert_array_equal(np.concatenate(shards)[:7], x)
    np.testing.assert_array_equal(shards[2][1:], np.repeat(x[-1:], 2, axis=0))


def test_cv_mesh_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_cv_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsd.ShardDispatcher(devices=["v0"])


def test_ladder_rules_on_the_card(monkeypatch):
    """A stubbed device check stands in for the card: the default ladder is
    the kernel rungs, a ladder that moves to "ref" raises before anything
    runs, and ("ref",) alone is allowed."""
    monkeypatch.setattr(tsd, "resolve_device", lambda device=None: torch.device("cuda"))
    disp = tsd.ShardDispatcher(devices=["v0", "v1"])
    assert disp.card and disp.ladder == ("streaming", "tiled2d", "window")
    for bad in (("window", "ref"), ("streaming", "tiled2d", "window", "ref"), ("ref", "ref")):
        with pytest.raises(ValueError, match="plain version"):
            tsd.ShardDispatcher(devices=["v0"], ladder=bad)
    assert tsd.ShardDispatcher(devices=["v0"], ladder=("ref",)).ladder == ("ref",)
    with pytest.raises(ValueError, match="unknown ladder rung"):
        tsd.ShardDispatcher(devices=["v0"], ladder=("fast",))
    monkeypatch.undo()
    cpu = tsd.ShardDispatcher(devices=["v0"], device=torch.device("cpu"))
    assert cpu.ladder == jsd.DEGRADATION_LADDER


def test_dispatch_refusals_match_jax():
    disp = tsd.ShardDispatcher(devices=["v0"], device="cpu")
    with pytest.raises(ValueError, match="empty batch"):
        disp.dispatch(np.zeros((0, 4, 4), np.float32), stub("torch"))
    with pytest.raises(ValueError, match="not both"):
        tsd.ShardDispatcher(tmesh.make_cv_mesh(device="cpu"), devices=["v0"], device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        tsd.ShardDispatcher(devices=[], device="cpu")

    def bad(x, rung):
        raise ValueError("misconfigured")

    with pytest.raises(ValueError, match="misconfigured"):
        disp.dispatch(np.zeros((2, 4, 4), np.float32), bad)
