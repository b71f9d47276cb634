"""The port's fault injection and degradation ladder against the JAX
package's, on the CPU.

Both modules are plain Python (and numpy); the same specs, calls and rung
sequences go to each, and the decisions and events must be the same:
  * `parse_spec` accepts and rejects the same strings, with the same specs;
  * `should_fire` fires on the same calls over 200 calls of several specs;
  * `poison` damages the same spots, `corrupt_text` the same way;
  * `resolve_rungs` / `resolve_classify_rungs` give the same tuples;
  * `run_ladder` under an injected ``lowering_error`` records an event with
    the same fields, also through the port's `fused_chain` on its plain
    versions and `ClassifyPlan`.
Each test starts and ends with no fault armed, an empty log, and the
default mode and ladder unset, in both packages.
"""

import numpy as np
import pytest
import torch

from repro.core import faultinject as jfi
from repro.cv import classify as jclassify
from repro.kernels.stencil import ladder as jladder

from repro_torch.core import autotune as tautotune
from repro_torch.core import faultinject as tfi
from repro_torch.cv import classify as tclassify
from repro_torch.cv.config import PipelineConfig
from repro_torch.cv.gbdt import GbdtModel
from repro_torch.kernels import counters, stencil
from repro_torch.kernels.stencil import ladder as tladder

EVENT_FIELDS = ("stage", "from_plan", "to_plan", "reason", "detail", "injected")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(tfi.ENV_VAR, raising=False)
    monkeypatch.delenv(jfi.ENV_VAR, raising=False)
    monkeypatch.setattr(tautotune, "_MODE_CACHE", {})
    monkeypatch.setattr(tautotune, "_DISK_CACHE_LOADED", True)  # never read a disk table
    saved = (tladder.set_default_chain_mode(None), tladder.set_default_ladder(None),
             jladder.set_default_chain_mode(None), jladder.set_default_ladder(None))
    with tfi.inject(None), jfi.inject(None):
        tfi.clear_degradation_log()
        jfi.clear_degradation_log()
        yield
    tfi.clear_degradation_log()
    jfi.clear_degradation_log()
    tladder.set_default_chain_mode(saved[0])
    tladder.set_default_ladder(saved[1])
    jladder.set_default_chain_mode(saved[2])
    jladder.set_default_ladder(saved[3])


def _fields(ev) -> tuple:
    return tuple(getattr(ev, f) for f in EVENT_FIELDS)


SPECS = [
    "",
    "   ",
    "lowering_error",
    "lowering_error:p=0.5,seed=11;cache_corrupt;nan_input:count=2",
    "measure_timeout:after=3,count=1",
    " device_loss : p=0.25 ; shard_oom:seed=4 ;",
    "collective_timeout:p=1.0",
    "bucket_miss:count=0",
    "lowering_error;lowering_error:p=0.1",
    "bogus_kind",
    "lowering_error:q=1",
    "lowering_error:p=abc",
    "lowering_error:count=1.5",
    "nan_input:seed=",
]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_accepts_and_rejects_like_jax(text):
    def parsed(mod):
        try:
            return {k: (v.kind, v.p, v.count, v.after, v.seed)
                    for k, v in mod.parse_spec(text).items()}
        except ValueError:
            return "ValueError"

    assert parsed(tfi) == parsed(jfi)


FIRE_SPECS = [
    "lowering_error:p=0.3,seed=7",
    "lowering_error:p=0.5,after=10,count=20,seed=3",
    "cache_corrupt:count=3",
    "nan_input:p=0.9,seed=2,after=5",
    "measure_timeout:p=0.01,seed=99",
    "lowering_error:p=0.7;cache_corrupt:p=0.2,seed=5",
]


@pytest.mark.parametrize("text", FIRE_SPECS)
def test_should_fire_fires_on_the_calls_jax_fires_on(text):
    kinds = sorted(tfi.parse_spec(text)) + ["shard_oom"]  # an unarmed kind never fires
    tr, jr = tfi.FaultRegistry(tfi.parse_spec(text)), jfi.FaultRegistry(jfi.parse_spec(text))
    got = [tr.should_fire(kinds[i % len(kinds)], f"s{i}") for i in range(200)]
    want = [jr.should_fire(kinds[i % len(kinds)], f"s{i}") for i in range(200)]
    assert got == want
    assert tr.fired == jr.fired
    assert {k: tr.fire_count(k) for k in kinds} == {k: jr.fire_count(k) for k in kinds}


def test_module_level_firing_and_inject_restore_like_jax():
    with tfi.inject("lowering_error:p=0.4,seed=1") as reg:
        assert reg is tfi.registry()
        got = [tfi.should_fire("lowering_error") for _ in range(50)]
        with tfi.inject(None):
            assert tfi.registry() is None
            tfi.maybe_raise("lowering_error")  # nothing armed: no raise
        assert tfi.registry() is reg
    with jfi.inject("lowering_error:p=0.4,seed=1"):
        want = [jfi.should_fire("lowering_error") for _ in range(50)]
    assert got == want and any(got) and not all(got)
    assert tfi.registry() is None
    with tfi.inject("lowering_error"), pytest.raises(tfi.InjectedFault, match="at site-a"):
        tfi.maybe_raise("lowering_error", "site-a")


def test_environment_variables_arm_only_their_own_package(monkeypatch):
    monkeypatch.setattr(tfi, "_ENV_CONSULTED", False)
    monkeypatch.setattr(tfi, "_REGISTRY", None)
    monkeypatch.setenv(jfi.ENV_VAR, "lowering_error")
    assert tfi.ENV_VAR != jfi.ENV_VAR
    assert tfi.registry() is None  # JAX's variable does not arm the port
    monkeypatch.setattr(tfi, "_ENV_CONSULTED", False)
    monkeypatch.setenv(tfi.ENV_VAR, "cache_corrupt:count=1")
    reg = tfi.registry()
    assert set(reg.specs) == {"cache_corrupt"}
    assert tfi.should_fire("cache_corrupt") and not tfi.should_fire("cache_corrupt")


@pytest.mark.parametrize("shape", [(5000,), (40, 60), (3, 7)])
def test_poison_damages_the_spots_jax_damages(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    spec = "nan_input:seed=5,count=2"
    with tfi.inject(spec):
        t1, f1 = tfi.poison(torch.from_numpy(x), "a")
        t2, f2 = tfi.poison(torch.from_numpy(x), "b")
        t3, f3 = tfi.poison(torch.from_numpy(x), "c")  # count spent
        ti, fi = tfi.poison(torch.zeros(shape, dtype=torch.int32), "d")  # not eligible
    with jfi.inject(spec):
        j1, g1 = jfi.poison(x, "a")
        j2, g2 = jfi.poison(x, "b")
        j3, g3 = jfi.poison(x, "c")
    assert (f1, f2, f3, fi) == (g1, g2, g3, False) == (True, True, False, False)
    for t, j in ((t1, j1), (t2, j2), (t3, j3)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(ti, torch.zeros(shape, dtype=torch.int32))
    assert np.isnan(t1.numpy()).any() or np.isinf(t1.numpy()).any()


def test_corrupt_text_like_jax():
    text = '{"a": {"mode": "window"}, "b": 1}'
    with tfi.inject("cache_corrupt"), jfi.inject("cache_corrupt"):
        assert tfi.corrupt_text(text, "p") == jfi.corrupt_text(text, "p")
    assert tfi.corrupt_text(text) == (text, False)


def test_degradation_log_counts_and_scopes():
    with tfi.collect_events() as outer:
        tfi.record_degradation(stage="fused_chain", from_plan="streaming", to_plan="window",
                               reason="r" * 400)
        with tfi.collect_events() as inner:
            tfi.record_degradation(stage="fused_chain", from_plan="streaming",
                                   to_plan="window", reason="again", injected=True)
    assert len(outer) == 2 and len(inner) == 1 and inner[0].injected
    assert len(outer[0].reason) == 300
    assert tfi.degradation_counts() == {("fused_chain", "streaming", "window"): 2}
    assert [e.reason for e in tfi.degradation_log()] == ["r" * 300, "again"]
    tfi.clear_degradation_log()
    assert tfi.degradation_log() == [] and tfi.degradation_counts() == {}


RUNG_CASES = [
    (m, lad)
    for m in ("streaming", "tiled2d", "window", "ref")
    for lad in (None, (), ("streaming", "tiled2d", "window", "ref"), ("window", "ref"),
                ("ref",), ("tiled2d", "streaming", "tiled2d"), ("bogus",))
]


@pytest.mark.parametrize("mode,ladder", RUNG_CASES)
def test_resolve_rungs_like_jax(mode, ladder):
    def rungs(mod):
        try:
            return mod.resolve_rungs(mode, ladder)
        except ValueError:
            return "ValueError"

    assert rungs(tladder) == rungs(jladder)
    assert tladder.MODES == jladder.MODES
    assert tladder.DEGRADATION_LADDER == jladder.DEGRADATION_LADDER


def test_default_ladder_and_mode_like_jax():
    for mod in (tladder, jladder):
        assert mod.set_default_ladder(["window", "ref"]) is None
        assert mod.default_ladder() == ("window", "ref")
        assert mod.resolve_rungs("streaming", None) == ("streaming", "window", "ref")
        assert mod.set_default_ladder(()) == ("window", "ref")
        assert mod.default_ladder() is None
        with pytest.raises(ValueError):
            mod.set_default_ladder(("nope",))
        with pytest.raises(ValueError):
            mod.set_default_chain_mode("nope")
        assert mod.set_default_chain_mode("window") is None
        assert mod.set_default_chain_mode(None) == "window"


@pytest.mark.parametrize(
    "mode,ladder",
    [(m, lad) for m in ("fused", "ref", "bogus")
     for lad in (None, (), ("fused", "ref"), ("ref",), ("ref", "fused"), ("x",))],
)
def test_resolve_classify_rungs_like_jax(mode, ladder):
    def rungs(mod):
        try:
            return mod.resolve_classify_rungs(mode, ladder)
        except ValueError:
            return "ValueError"

    assert rungs(tclassify) == rungs(jclassify)
    assert tclassify.CLASSIFY_LADDER == jclassify.CLASSIFY_LADDER


@pytest.mark.parametrize(
    "mode,ladder,ok",
    [("window", ("window", "ref"), False), ("streaming", tladder.DEGRADATION_LADDER, False),
     ("window", ("ref",), False), ("streaming", ("streaming", "window"), True),
     ("ref", ("window", "ref"), True), ("window", ("ref", "window"), True),
     ("window", None, True)],
)
def test_no_ladder_moves_to_ref_on_a_cuda_tensor(mode, ladder, ok):
    """On a CUDA tensor a ladder (the caller's or the process default) that
    moves to "ref" raises; one that stays on kernels, or an explicit mode
    "ref", resolves as on the CPU."""
    cpu = tladder.resolve_rungs(mode, ladder)
    if ok:
        assert tladder.resolve_rungs(mode, ladder, card=True) == cpu
    else:
        assert cpu[-1] == "ref"
        with pytest.raises(ValueError, match="moves to 'ref'"):
            tladder.resolve_rungs(mode, ladder, card=True)
    tladder.set_default_ladder(ladder)
    if ok:
        assert tladder.resolve_rungs(mode, None, card=True) == cpu
    else:
        with pytest.raises(ValueError, match="moves to 'ref'"):
            tladder.resolve_rungs(mode, None, card=True)
    cmode = {"window": "fused", "streaming": "fused"}.get(mode, mode)
    cladder = None if ladder is None else tuple(dict.fromkeys(
        {"window": "fused", "streaming": "fused", "tiled2d": "fused"}.get(r, r) for r in ladder))
    crungs = tclassify.resolve_classify_rungs(cmode, cladder)
    if "ref" in crungs[1:]:
        with pytest.raises(ValueError, match="moves to 'ref'"):
            tclassify.resolve_classify_rungs(cmode, cladder, card=True)
    else:
        assert tclassify.resolve_classify_rungs(cmode, cladder, card=True) == crungs


@pytest.mark.parametrize("rungs", [("streaming", "tiled2d", "window", "ref"), ("fused", "ref")])
def test_run_ladder_records_the_event_jax_records(rungs):
    spec = "lowering_error:count=2"

    def runner(fi):
        def run(rung):
            if rung != "ref":
                fi.maybe_raise("lowering_error", site=f"fused_chain:{rung}")
            return rung
        return run

    with tfi.inject(spec):
        got = tladder.run_ladder(rungs, runner(tfi), stage="fused_chain", detail="(4, 4)|uint8")
    with jfi.inject(spec):
        want = jladder.run_ladder(rungs, runner(jfi), stage="fused_chain", detail="(4, 4)|uint8")
    assert got == want == rungs[min(2, len(rungs) - 1)]
    assert [_fields(e) for e in tfi.degradation_log()] == [_fields(e) for e in jfi.degradation_log()]
    assert all(e.injected for e in tfi.degradation_log())


def test_run_ladder_value_error_propagates_and_last_rung_raises():
    def bad_value(rung):
        raise ValueError("misconfigured")

    with pytest.raises(ValueError):
        tladder.run_ladder(("streaming", "window"), bad_value, stage="s", detail="d")
    assert tfi.degradation_log() == []

    def always(rung):
        raise RuntimeError(f"{rung} failed")

    with pytest.raises(RuntimeError, match="window failed"):
        tladder.run_ladder(("streaming", "window"), always, stage="s", detail="d")
    (ev,) = tfi.degradation_log()
    assert (ev.from_plan, ev.to_plan, ev.injected) == ("streaming", "window", False)


def test_fused_chain_ladder_moves_one_rung_under_an_injected_fault():
    """The port's `fused_chain` on the CPU (the plain version of each
    rung's kernel) under ladder ("streaming", "window"): the injected
    fault fires before `stencil_stream`'s plain version runs, the window
    rung's runs, one event is recorded with JAX's fields for the same
    rungs and detail, and the output is the window mode's."""
    x = torch.from_numpy(np.random.default_rng(2).random((2, 24, 20, 3)).astype(np.float32))
    chain = (stencil.gaussian_stage(5), stencil.erode_stage(1))
    want = stencil.fused_chain(x, chain, mode="window")
    counters.reset()
    with tfi.inject("lowering_error:count=1"):
        got = stencil.fused_chain(x, chain, mode="streaming", ladder=("streaming", "window"))
    assert torch.equal(got, want)
    assert counters.PLAIN_CALLS["stencil_stream"] == 0
    assert counters.PLAIN_CALLS["stencil_chain"] == 1
    (ev,) = tfi.degradation_log()

    def run(rung):
        jfi.maybe_raise("lowering_error", site=f"fused_chain:{rung}")

    with jfi.inject("lowering_error:count=1"):
        jladder.run_ladder(("streaming", "window"), run, stage="fused_chain",
                           detail="(2, 24, 20, 3)|float32")
    (jev,) = jfi.degradation_log()
    assert _fields(ev) == _fields(jev)
    assert ev.injected and ev.reason == "InjectedFault: injected lowering_error at fused_chain:streaming"


def test_fused_chain_without_a_ladder_raises_the_fault():
    x = torch.zeros((16, 16), dtype=torch.float32)
    with tfi.inject("lowering_error"), pytest.raises(tfi.InjectedFault):
        stencil.fused_chain(x, (stencil.erode_stage(1),), mode="window")
    assert tfi.degradation_log() == []
    # the process-default ladder takes over when the call names none
    tladder.set_default_ladder(("window", "ref"))
    with tfi.inject("lowering_error"):
        out = stencil.fused_chain(x, (stencil.erode_stage(1),), mode="window")
    assert out.shape == (16, 16)
    assert [(e.from_plan, e.to_plan) for e in tfi.degradation_log()] == [("window", "ref")]


def _gbdt_plan(ladder):
    rng = np.random.default_rng(3)
    K, D, C, T, depth = 6, 8, 3, 4, 2
    model = GbdtModel(
        torch.from_numpy(rng.integers(0, K, (T, depth)).astype(np.int32)),
        torch.from_numpy(rng.random((T, depth)).astype(np.float32) * 0.3),
        torch.from_numpy(rng.standard_normal((T, 2**depth, C)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(C).astype(np.float32)),
        C,
    )
    cents = torch.from_numpy(rng.random((K, D)).astype(np.float32))
    descs = torch.from_numpy(rng.random((5, 7, D)).astype(np.float32))
    valids = torch.from_numpy(rng.random((5, 7)) < 0.8)
    plan = tclassify.ClassifyPlan(cents, C, head="gbdt", gbdt=model, ladder=ladder)
    return plan, descs, valids


def test_classify_plan_ladder_is_opt_in_and_records_each_move():
    """JAX's ladder default is ("fused", "ref"); the port's is None, so a
    failing fused rung raises.  With JAX's ladder passed, the fault moves
    the tail to ref with one event per call, as JAX records it."""
    assert PipelineConfig().classify_ladder is None and PipelineConfig().ladder is None
    plan, descs, valids = _gbdt_plan(None)
    assert plan.ladder is None
    with tfi.inject("lowering_error"), pytest.raises(tfi.InjectedFault):
        plan.histograms(descs, valids)
    plan, descs, valids = _gbdt_plan(["fused", "ref"])
    assert plan.ladder == ("fused", "ref")
    want = plan(descs, valids, mode="ref")
    with tfi.inject("lowering_error:count=2"):
        got = plan(descs, valids)
    for k in ("hist", "scores", "label"):
        assert torch.equal(got[k], want[k])
    evs = tfi.degradation_log()
    assert [(e.stage, e.from_plan, e.to_plan, e.injected) for e in evs] == [
        ("classify_hist", "fused", "ref", True), ("classify_score", "fused", "ref", True)]
    assert evs[0].detail == "classify:gbdt:k6d8c3|5x7x8|float32"
    assert evs[0].reason == "InjectedFault: injected lowering_error at classify:fused"
