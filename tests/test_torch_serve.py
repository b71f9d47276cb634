"""The port's CV serving engine against the JAX package's, on the CPU.

  * **Engine logic, shared stub.**  `_run_batch` of both engines is replaced
    (in the test only) by one numpy stub that records the canonical batches
    it sees and raises on chosen rungs or calls.  Admission (rank, dtype,
    ``faultinject.poison`` with sanitize or reject), bucketing and edge
    padding (``bucket_miss`` too), grouping and `max_batch` splits, the
    ladder with bounded retry and backoff, retries abandoned before a
    deadline, pre- and post-compute deadlines and `ValueError` propagating
    must give equal `Response` fields, batches, stats and events.
  * **Sharded route.**  Both engines over a dispatcher of virtual devices
    ["v0", "v1"] with a shared `_batch_fn` stub, under ``shard_oom`` and
    ``device_loss``: equal shards, devices, plans and events.
  * **The real pipeline.**  Descriptors at each rung of the port (its
    plain versions on the CPU) against JAX's: on the 32x32 bucket JAX runs
    its default ladder (its `fused_chain` runs `chain_ref` under every mode
    there), on the 48x48 bucket ``ladder=("ref",)`` (JAX's Pallas stencil
    plans do not lower on every jax release).  Valid masks and buckets are
    exact, descriptors at atol 1e-5 for at least 95% of the valid keypoints
    (`tests/test_torch_features.py` says why).  Predictions of carried-over
    SVM and GBDT models are equal.
  * `_smoke` under every fault kind, `warm()`, the config shims, and the two
    departures on the card (a stubbed device check).
Every test starts and ends with no fault armed, an empty degradation log and
both plan tables under ``tmp_path``.
"""

import os
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import faultinject as jfi
from repro.cv import pipeline as jpipeline
from repro.cv.config import PipelineConfig as JaxConfig
from repro.data.synthetic import ImageStream as JaxImageStream
from repro.serve import cv_engine as jce
from repro.serve import shard_dispatch as jsd

from repro_torch import convert
from repro_torch.core import autotune as tat
from repro_torch.core import faultinject as tfi
from repro_torch.cv import pipeline as tpipeline
from repro_torch.cv.config import PipelineConfig, resolve_config
from repro_torch.kernels import counters
from repro_torch.serve import cv_engine as tce
from repro_torch.serve import shard_dispatch as tsd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_FIELDS = ("stage", "from_plan", "to_plan", "reason", "detail", "injected")
RESPONSE_FIELDS = ("index", "ok", "bucket", "plan", "retries", "degraded", "deadline_missed",
                   "shard", "device", "error")
BUCKETS = ((32, 32), (48, 48))
RUNGS = ("streaming", "tiled2d", "window", "ref")


class TickClock:
    """A `time` stand-in for the dispatchers: 1 ms a reading, so both
    ledgers read the same latencies and rank devices alike."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv(tat.CACHE_ENV, str(tmp_path / "torch" / "chain_autotune.json"))
    monkeypatch.delenv(tat.CACHE_READ_ENV, raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax" / "chain_autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE_READ", raising=False)
    monkeypatch.delenv(tfi.ENV_VAR, raising=False)
    monkeypatch.delenv(jfi.ENV_VAR, raising=False)
    for mod in (tat, jat):
        monkeypatch.setattr(mod, "_MODE_CACHE", {})
        monkeypatch.setattr(mod, "_DISK_CACHE_LOADED", False)
    with tfi.inject(None), jfi.inject(None):
        tfi.clear_degradation_log()
        jfi.clear_degradation_log()
        yield
    tfi.clear_degradation_log()
    jfi.clear_degradation_log()


def events_of(evs) -> list:
    return [tuple(getattr(e, f) for f in EVENT_FIELDS) for e in evs]


def mixed_work(seed: int = 0) -> list:
    """u8 RGB and f32 / f64 gray frames of many sizes, a (H, W, 1) frame,
    three malformed frames and one larger than every bucket."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(14):
        h, w = (int(v) for v in rng.integers(18, 49, 2))
        if i % 3 == 0:
            work.append(rng.random((h, w), dtype=np.float32) * 255)
        else:
            work.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    work += [rng.random((30, 30, 1), dtype=np.float32), rng.random((28, 31)),
             np.zeros((8, 8, 2), np.uint8), np.zeros((8,), np.float32),
             np.zeros((16, 16), np.int32), rng.integers(0, 256, (70, 40, 3), dtype=np.uint8)]
    return work


class StubBatch:
    """The shared `_run_batch`: numpy only, so both engines get equal
    outputs from equal batches.  `fail(call, rung)` names the exception a
    call raises (None: it succeeds); `sleep_s` is spent in every call."""

    def __init__(self, fi, fail=None, sleep_s: float = 0.0):
        self.fi, self.fail, self.sleep_s = fi, fail, sleep_s
        self.calls = []

    def __call__(self, batch, rung):
        n = len(self.calls)
        self.calls.append((rung, batch.copy()))
        time.sleep(self.sleep_s)
        kind = self.fail(n, rung) if self.fail else None
        if kind == "runtime":
            raise RuntimeError(f"stub failure at {rung}")
        if kind == "injected":
            raise self.fi.InjectedFault(f"injected stub fault at {rung}")
        if kind == "value":
            raise ValueError("misconfigured stub")
        flat = batch.reshape(batch.shape[0], -1).astype(np.float64)
        desc = np.stack([flat.mean(1), flat.max(1), flat.min(1)], axis=1).astype(np.float32)
        return {"desc": desc, "valid": flat.max(1) > 100}


def response_row(r) -> tuple:
    return tuple(getattr(r, f) for f in RESPONSE_FIELDS)


def serve_both(work_fn, spec=None, fail=None, sleep_s=0.0, **kw) -> tuple:
    """The same workload (`work_fn(engine module)`, whose `Request` it
    uses) through both engines with the shared stub -> (port's, JAX's)
    observations."""
    out = []
    for side in ("torch", "jax"):
        fi, mod = (tfi, tce) if side == "torch" else (jfi, jce)
        extra = {"device": "cpu"} if side == "torch" else {}
        eng = mod.CvEngine(buckets=BUCKETS, max_kp=8, **kw, **extra)
        stub = StubBatch(fi, fail, sleep_s)
        eng._run_batch = stub
        with fi.inject(spec), fi.collect_events() as evs:
            res = eng.submit(work_fn(mod))
        stats = {k: v for k, v in eng.stats.items() if k != "last_submit_s"}
        out.append({
            "rows": [response_row(r) for r in res],
            "desc": [None if r.desc is None else r.desc for r in res],
            "valid": [None if r.valid is None else r.valid for r in res],
            "events": [events_of(r.events) for r in res],
            "log": events_of(evs),
            "stats": stats,
            "calls": stub.calls,
        })
    return tuple(out)


def assert_same(got: dict, want: dict) -> None:
    assert got["rows"] == want["rows"]
    for g, w in zip(got["desc"] + got["valid"], want["desc"] + want["valid"], strict=True):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert got["events"] == want["events"]
    assert got["log"] == want["log"]
    assert got["stats"] == want["stats"]
    assert [c[0] for c in got["calls"]] == [c[0] for c in want["calls"]]
    for (_, g), (_, w) in zip(got["calls"], want["calls"], strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def fail_rungs(*rungs, kind="runtime"):
    return lambda n, rung: kind if rung in rungs else None


def fail_first(k: int, kind="runtime"):
    return lambda n, rung: kind if n < k else None


STUB_CASES = {
    "fault-free, split by max_batch": ({}, None, None),
    "one batch": ({"max_batch": 64}, None, None),
    "nan_input sanitized": ({}, "nan_input:count=3", None),
    "nan_input seeded": ({}, "nan_input:p=0.5,seed=4", None),
    "nan_input rejected": ({"bad_input": "reject"}, "nan_input", None),
    "bucket_miss once": ({}, "bucket_miss:count=1", None),
    "bucket_miss seeded": ({}, "bucket_miss:p=0.4,seed=2", None),
    "transient failure retried": ({"backoff_s": 0.0}, None, fail_first(1)),
    "rung fails, retried, degraded": ({"backoff_s": 0.0}, None, fail_rungs("streaming")),
    "injected fault, no retry": ({"max_retries": 0}, None,
                                 fail_rungs("streaming", "tiled2d", kind="injected")),
    "every rung fails": ({"backoff_s": 0.0, "max_retries": 0}, None,
                         fail_rungs(*RUNGS)),
    "kernel ladder, every rung fails": ({"ladder": ("streaming", "window"), "backoff_s": 0.0},
                                        None, fail_rungs("streaming", "window")),
    "all faults at once": ({"backoff_s": 0.0},
                           "nan_input:p=0.5;bucket_miss:p=0.3,seed=5", fail_first(2)),
}


@pytest.mark.parametrize("name", STUB_CASES)
def test_engine_logic_replays_jax(name):
    kw, spec, fail = STUB_CASES[name]
    kw = dict({"max_batch": 3}, **kw)
    got, want = serve_both(lambda mod: mixed_work(), spec, fail, **kw)
    assert_same(got, want)
    rows = got["rows"]
    assert [r[1] for r in rows[-4:-1]] == [False, False, False]  # the malformed frames
    assert [r[9].split(":")[0] for r in rows[-4:-1]] == ["bad_rank", "bad_rank", "bad_dtype"]


def test_value_error_propagates_from_both():
    for side in ("torch", "jax"):
        mod, fi = (tce, tfi) if side == "torch" else (jce, jfi)
        eng = mod.CvEngine(buckets=BUCKETS, max_kp=8, **({"device": "cpu"} if side == "torch"
                                                         else {}))
        eng._run_batch = StubBatch(fi, fail_first(1, "value"))
        with pytest.raises(ValueError, match="misconfigured stub"):
            eng.submit(mixed_work())


def test_deadlines_pre_and_post_compute_replay_jax():
    """A request already late is answered without compute; one that expires
    during the stub's 1.5 s is answered and flagged late."""
    frame = np.random.default_rng(6).integers(0, 256, (30, 30, 3), dtype=np.uint8)

    def work(mod):
        now = time.monotonic()
        return [mod.Request(frame, deadline=now - 1.0), mod.Request(frame, deadline=now + 1.0),
                mod.Request(frame)]

    got, want = serve_both(work, sleep_s=1.5)
    assert_same(got, want)
    rows = got["rows"]
    assert rows[0][1] is False and rows[0][9] == "deadline_exceeded"
    assert rows[1][1] is True and rows[1][6] is True and rows[2][6] is False
    assert got["stats"]["deadline_missed"] == 2


def test_retry_abandoned_before_the_deadline_replays_jax():
    """A 120 s backoff cannot fit before a deadline 2 s out: the retry is
    abandoned (no retry counted) and the ladder moves on at once; the
    same failure without deadlines retries."""
    frames = [np.random.default_rng(9).random((40, 40), dtype=np.float32) for _ in range(2)]

    def work(mod):
        return [mod.Request(f, deadline=time.monotonic() + 2.0) for f in frames]

    t0 = time.monotonic()
    got, want = serve_both(work, fail=fail_first(1), max_retries=3, backoff_s=120.0)
    assert time.monotonic() - t0 < 60.0
    assert_same(got, want)
    assert [r[3] for r in got["rows"]] == ["tiled2d", "tiled2d"]
    assert got["stats"]["retries"] == 0 and got["stats"]["deadline_missed"] == 1
    assert any("retry abandoned" in e[3] for e in got["events"][0])
    got, want = serve_both(lambda mod: frames, fail=fail_first(1), max_retries=3,
                           backoff_s=0.0)
    assert_same(got, want)
    assert [r[3] for r in got["rows"]] == ["streaming", "streaming"]
    assert got["stats"]["retries"] == 1


def batch_fn_stub(side: str):
    """The shared `_batch_fn` of the sharded route: y = per-image mean,
    arithmetic on each side's arrays."""

    def fn(x, rung):
        if side == "jax":
            return {"desc": jnp.mean(jnp.asarray(x, jnp.float32).reshape(x.shape[0], -1),
                                     axis=1, keepdims=True)}
        return {"desc": x.to(torch.float32).reshape(x.shape[0], -1).mean(1, keepdim=True)}

    return fn


@pytest.mark.parametrize("spec", [None, "shard_oom:count=1", "device_loss:count=1",
                                  "device_loss:count=1;shard_oom:count=2"])
def test_sharded_route_replays_jax(spec, monkeypatch):
    monkeypatch.setattr(tsd, "time", TickClock())
    monkeypatch.setattr(jsd, "time", TickClock())
    out = []
    for side in ("torch", "jax"):
        fi, mod, sd = (tfi, tce, tsd) if side == "torch" else (jfi, jce, jsd)
        extra = {"device": "cpu"} if side == "torch" else {}
        disp = sd.ShardDispatcher(devices=["v0", "v1"], **extra)
        eng = mod.CvEngine(buckets=BUCKETS, max_kp=8, max_batch=4, dispatcher=disp, **extra)
        eng._batch_fn = batch_fn_stub(side)
        with fi.inject(spec), fi.collect_events() as evs:
            res = eng.submit(mixed_work())
        out.append({"rows": [response_row(r) for r in res],
                    "desc": [r.desc for r in res],
                    "events": [events_of(r.events) for r in res], "log": events_of(evs),
                    "stats": {k: v for k, v in eng.stats.items() if k != "last_submit_s"},
                    "disp": dict(disp.stats), "lost": disp.lost_devices()})
    got, want = out
    for k in ("rows", "events", "log", "stats", "disp", "lost"):
        assert got[k] == want[k], k
    for g, w in zip(got["desc"], want["desc"], strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-6) if w is not None else None
    assert got["stats"]["sharded_batches"] > 0
    assert {r[8] for r in got["rows"] if r[1]} <= {"v0", "v1"}


# -- the real pipeline ---------------------------------------------------------------


def frames(seed: int) -> list:
    """Crops of ImageStream images: 4 u8 RGB frames for the 32x32 bucket
    and 2 f32 gray frames for the 48x48 one."""
    imgs, _ = JaxImageStream(res=48).batch(6, split=seed)
    imgs = np.asarray(imgs)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        h, w = (int(v) for v in rng.integers(24, 33, 2))
        out.append(np.ascontiguousarray(imgs[i, :h, :w]))
    for i in range(4, 6):
        h, w = (int(v) for v in rng.integers(40, 49, 2))
        out.append(imgs[i, :h, :w].astype(np.float32).mean(axis=-1))
    return out


def jax_serve(work, model=None, cfg=None) -> list:
    """JAX's engine: its default ladder on the 32x32 bucket, ("ref",) on
    the 48x48 one."""
    cfg = cfg if cfg is not None else JaxConfig(max_kp=16, preprocess=True)
    small = [i for i, f in enumerate(work) if max(f.shape[:2]) <= 32]
    large = [i for i in range(len(work)) if i not in small]
    res = [None] * len(work)
    for idx, kw in ((small, {"buckets": ((32, 32),)}),
                    (large, {"buckets": ((48, 48),), "ladder": ("ref",)})):
        eng = jce.CvEngine(model, config=cfg, **kw)
        for i, r in zip(idx, eng.submit([work[i] for i in idx])):
            res[i] = r
    assert all(r.ok for r in res)
    return res


@pytest.fixture(scope="module")
def extract_want():
    work = frames(31)
    return work, jax_serve(work)


@pytest.mark.parametrize("rung", RUNGS)
def test_descriptors_at_each_rung_match_jax(rung, extract_want):
    work, want = extract_want
    eng = tce.CvEngine(config=PipelineConfig(max_kp=16, preprocess=True), buckets=BUCKETS,
                       ladder=(rung,), device="cpu")
    counters.reset()
    got = eng.extract(work)
    assert sum(counters.LAUNCHES.values()) == 0
    assert all(r.ok and r.plan == rung and not r.degraded for r in got)
    off, total = [], 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.bucket == w.bucket
        np.testing.assert_array_equal(g.valid, w.valid)
        err = np.abs(g.desc - w.desc).max(axis=1)
        assert np.all(err[~w.valid] == 0.0)
        total += int(w.valid.sum())
        off += [(i, j, float(err[j])) for j in np.nonzero(w.valid & (err > 1e-5))[0]]
    assert total > 0
    assert len(off) <= 0.05 * total, f"descriptors off at a bin edge: {off}"


@pytest.fixture(scope="module")
def models():
    stream = JaxImageStream(res=48)
    imgs, labels = stream.batch(16, split=21)
    out = {}
    for head in ("svm", "gbdt"):
        cfg = JaxConfig(mode="ref", preprocess=True, head=head)
        m = jpipeline.train(jax.random.key(0), imgs, labels, cfg, dict_size=16)
        if head == "svm":
            port = convert.from_jax_model(np.asarray(m.centroids), np.asarray(m.svm["w"]),
                                          np.asarray(m.svm["b"]), m.n_classes, device="cpu")
        else:
            g = m.gbdt
            port = convert.from_jax_gbdt_model(
                np.asarray(m.centroids), np.asarray(g.feat), np.asarray(g.thr),
                np.asarray(g.leaf), np.asarray(g.base), m.n_classes, device="cpu")
        out[head] = (m, port)
    return out


@pytest.mark.parametrize("head", ["svm", "gbdt"])
def test_predictions_match_jax(head, models):
    jmodel, port = models[head]
    work = frames(41) + frames(42)
    want = jax_serve(work, jmodel, JaxConfig(preprocess=True, head=head))
    for rung in ("streaming", "ref"):
        eng = tce.CvEngine(port, config=PipelineConfig(preprocess=True, head=head),
                           buckets=BUCKETS, ladder=(rung,), device="cpu", capture_frames=True)
        got = eng.classify(work)
        assert all(r.ok and r.plan == rung for r in got)
        assert [r.pred for r in got] == [r.pred for r in want], rung
        assert len({r.pred for r in got}) > 1, "every frame got one label"
        assert all(isinstance(r.pred, int) for r in got)
        # the engine's predictions are `pipeline.predict`'s on the batches it served
        direct = np.concatenate([
            tpipeline.predict(port, torch.from_numpy(b),
                              PipelineConfig(preprocess=True, head=head, mode=rung,
                                             classify_mode="ref" if rung == "ref" else "fused"),
                              device="cpu").numpy()
            for _, b in eng.captured])
        order = [i for b in (32, 48) for i, r in enumerate(got) if r.bucket == (b, b)]
        assert [got[i].pred for i in order] == direct.tolist()


def test_sharded_route_matches_the_local_engine():
    work = frames(51)[:4]
    cfg = PipelineConfig(max_kp=8)
    local = tce.CvEngine(config=cfg, buckets=((32, 32),), device="cpu").extract(work)
    disp = tsd.ShardDispatcher(devices=["v0", "v1"], device="cpu")
    eng = tce.CvEngine(config=cfg, buckets=((32, 32),), dispatcher=disp, device="cpu")
    res = eng.extract(work)
    assert all(r.ok for r in res) and sorted({r.shard for r in res}) == [0, 1]
    assert eng.stats["sharded_batches"] == 1
    for a, b in zip(res, local):
        np.testing.assert_array_equal(a.desc, b.desc)
        np.testing.assert_array_equal(a.valid, b.valid)


# -- smoke, warm, config, departures ---------------------------------------------------


@pytest.mark.parametrize("kind", (None,) + tfi.FAULT_KINDS)
def test_smoke_survives_every_fault_kind(kind):
    with tfi.inject(kind):
        assert tce._smoke(verbose=False, device="cpu") == 0


@pytest.mark.parametrize("spec", ["lowering_error", "nan_input;bucket_miss:p=0.5"])
def test_smoke_command_line(spec):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_FAULT_SPEC=spec)
    p = subprocess.run([sys.executable, "-m", "repro_torch.serve.cv_engine", "--smoke",
                        "--device", "cpu"], env=env, capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "serve-smoke (cpu): 16 ok / 1 rejected" in p.stdout


def test_warm_replays_jax():
    evs = {}
    for side in ("torch", "jax"):
        fi, mod = (tfi, tce) if side == "torch" else (jfi, jce)
        eng = mod.CvEngine(buckets=BUCKETS, max_kp=8, **({"device": "cpu"} if side == "torch"
                                                         else {}))
        with fi.inject("measure_timeout:count=1"), fi.collect_events() as e:
            assert eng.warm((32, 32)) is None
        evs[side] = events_of(e)
    assert evs["torch"] == evs["jax"] and len(evs["torch"]) == 1
    assert evs["torch"][0][1:3] == ("measured-plan", "heuristic")
    disp = tsd.ShardDispatcher(devices=["v0"], device="cpu")
    eng = tce.CvEngine(buckets=BUCKETS, dispatcher=disp, device="cpu")
    entry = eng.warm((32, 32), deadline_s=60.0)
    assert entry is not None and entry["mode"] in RUNGS
    assert disp.health.stats("v0").successes == 1
    assert eng.watchdog.n == len(entry["times"])


@pytest.mark.parametrize("kw", [{}, {"max_kp": 8}, {"preprocess": True},
                                {"n_octaves": 2, "preprocess": False, "max_kp": 4}])
def test_config_shims_warn_as_jax(kw):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        eng = tce.CvEngine(buckets=BUCKETS, device="cpu", **kw)
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter("always")
        jeng = jce.CvEngine(buckets=BUCKETS, **kw)
    dep = [(w.category, str(w.message)) for w in got if w.category is DeprecationWarning]
    jdep = [(w.category, str(w.message)) for w in want if w.category is DeprecationWarning]
    assert dep == jdep and len(dep) == int(bool({"preprocess", "n_octaves"} & set(kw)))
    assert (eng.max_kp, eng.n_octaves, eng.preprocess) == (jeng.max_kp, jeng.n_octaves,
                                                           jeng.preprocess)
    assert eng.signature == jeng.signature


def test_resolve_config_matches_jax():
    from repro.cv.config import resolve_config as jresolve

    with pytest.warns(DeprecationWarning) as got:
        cfg = resolve_config(PipelineConfig(max_kp=4), where="f", mode="window", ladder=None,
                             head="gbdt", max_kp=9)
    with pytest.warns(DeprecationWarning) as want:
        jcfg = jresolve(JaxConfig(max_kp=4), where="f", mode="window", ladder=None,
                        head="gbdt", max_kp=9)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert (cfg.mode, cfg.ladder, cfg.head, cfg.max_kp) == (jcfg.mode, jcfg.ladder, jcfg.head,
                                                            jcfg.max_kp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_config(None, where="f") == PipelineConfig()
    with pytest.raises(ValueError, match="expects a PipelineConfig"):
        resolve_config(JaxConfig(), where="f")


def test_engine_refusals_match_jax():
    for bad in ({"bad_input": "drop"}, {"ladder": ()}, {"ladder": ("fast",)}):
        with pytest.raises(ValueError):
            tce.CvEngine(device="cpu", **bad)
        with pytest.raises(ValueError):
            jce.CvEngine(**bad)
    disp = tsd.ShardDispatcher(devices=["v0"], device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tce.CvEngine(mesh=object(), dispatcher=disp, device="cpu")
    with pytest.raises(ValueError, match="classify needs a trained model"):
        tce.CvEngine(device="cpu").classify([])


def test_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tce.CvEngine()


def test_the_two_departures_on_the_card(monkeypatch):
    """A stubbed device check stands in for the card: the default ladder is
    the kernel rungs, a ladder in which "ref" follows another rung raises
    before anything runs, and ("ref",) alone is allowed.  On the CPU the
    default is JAX's."""
    monkeypatch.setattr(tce, "resolve_device", lambda device=None: torch.device("cuda"))
    counters.reset()
    assert tce.CvEngine().ladder == ("streaming", "tiled2d", "window")
    for bad in (("window", "ref"), tce.DEFAULT_LADDER, ("streaming", "ref", "window")):
        with pytest.raises(ValueError, match="plain version"):
            tce.CvEngine(ladder=bad)
    assert tce.CvEngine(ladder=("ref",)).ladder == ("ref",)
    assert sum(counters.LAUNCHES.values()) + sum(counters.PLAIN_CALLS.values()) == 0
    monkeypatch.undo()
    assert tce.CvEngine(device="cpu").ladder == jce.DEFAULT_LADDER == tce.DEFAULT_LADDER


def test_serve_package_exports_as_jax():
    import repro.serve as jserve
    import repro_torch.serve as tserve

    assert tserve.__all__ == jserve.__all__
    assert tserve.CvEngine is tce.CvEngine and tserve.Request is tce.Request
    assert tce.DEFAULT_BUCKETS == jce.DEFAULT_BUCKETS


def test_a_rung_that_cannot_plan_the_batch_moves_on():
    """The third departure: with a block's shared memory cut to 60,000 bytes
    the octave's streaming and tiled2d plans refuse 48x48 planes
    (`stencil.PlanOverBudget`), so each batch moves to "window" at once, one
    event a move and no retry, equal to `extract_features` at mode "window";
    the dispatcher does the same.  Where the refusing rung is the last, the
    `ValueError` propagates, as JAX's does."""
    from repro_torch.core.device import LaunchConfig
    from repro_torch.kernels import stencil

    cfg = PipelineConfig(max_kp=8, lc=LaunchConfig(smem_budget=60_000))
    work = frames(61)[4:]  # the two 40-48 pixel gray frames: the 48x48 bucket
    eng = tce.CvEngine(config=cfg, buckets=BUCKETS, capture_frames=True, device="cpu",
                       backoff_s=5.0)
    res = eng.extract(work)
    assert all(r.ok and r.plan == "window" and r.retries == 0 and r.degraded for r in res)
    assert [(e.from_plan, e.to_plan, e.injected) for e in res[0].events] == [
        ("streaming", "tiled2d", False), ("tiled2d", "window", False)]
    assert all(e.reason.startswith("rung cannot plan this batch") for e in res[0].events)
    assert eng.stats["retries"] == 0 and eng.stats["degraded_batches"] == 1
    (_, b), = eng.captured
    want = tpipeline.extract_features(b, cfg.replace(mode="window"), device="cpu")
    for k, r in enumerate(res):
        np.testing.assert_array_equal(r.desc, want["desc"][k].numpy())
    disp = tsd.ShardDispatcher(devices=["v0", "v1"], device="cpu")
    sres = tce.CvEngine(config=cfg, buckets=BUCKETS, dispatcher=disp, device="cpu").extract(work)
    assert all(r.ok and r.plan == "window" for r in sres)
    assert [(e.stage, e.from_plan, e.to_plan) for e in sres[0].events] == [
        ("dispatch", "streaming", "tiled2d"), ("dispatch", "tiled2d", "window")]
    for a, b_ in zip(sres, res):
        np.testing.assert_array_equal(a.desc, b_.desc)
    with pytest.raises(stencil.PlanOverBudget):
        tce.CvEngine(config=cfg, buckets=BUCKETS, ladder=("streaming", "tiled2d"),
                     device="cpu").extract(work)
