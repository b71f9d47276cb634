"""The port's measured mode choice and plan table against the JAX
package's, on the CPU.

  * `chain_signature` is JAX's string for the same chain (a filter, an
    erode, a Gaussian ladder with a pyrDown tap, a Sobel pair, the
    acceptance and preprocess chains, a warp);
  * `seal_entry` gives JAX's checksum for the same key and core;
  * `load_plan_table` on a damaged file (bad JSON, one bad entry, a wrong
    schema version, an injected ``cache_corrupt``) keeps the entries JAX's
    keeps and writes one quarantine file, as JAX's does;
  * ``fused_chain(mode=None)`` runs the mode `measure_chain` cached (by the
    plain versions' call counters), also from a table read back from disk,
    after `measure_pyramid` for every link of a pyramid, and
    ``ClassifyPlan(mode=None)`` the one `measure_classify` cached;
  * on a CUDA tensor (a stubbed device check, no card) ``"ref"`` is no
    candidate: naming it raises, and the default candidates are the kernel
    modes the chain can take.
Every test uses a plan table under ``tmp_path`` (never the home
directory) and starts and ends with an empty mode cache, no fault armed,
an empty degradation log and no default mode.
"""

import glob
import json
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core import faultinject as jfi
from repro.cv import features as jfeatures
from repro.kernels import stencil as jstencil

from repro_torch.core import autotune as tat
from repro_torch.core import faultinject as tfi
from repro_torch.cv import classify as tclassify
from repro_torch.cv import features as tfeatures
from repro_torch.kernels import counters, stencil
from repro_torch.kernels.stencil import driver
from repro_torch.kernels.stencil import ladder as tladder


@pytest.fixture(autouse=True)
def cache_env(tmp_path, monkeypatch):
    """Both packages' plan tables under tmp_path, their in-process caches
    empty, no read-back, nothing armed, no default mode or ladder."""
    path = tmp_path / "torch" / "chain_autotune.json"
    monkeypatch.setenv(tat.CACHE_ENV, str(path))
    monkeypatch.delenv(tat.CACHE_READ_ENV, raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax" / "chain_autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE_READ", raising=False)
    for mod in (tat, jat):
        monkeypatch.setattr(mod, "_MODE_CACHE", {})
        monkeypatch.setattr(mod, "_DISK_CACHE_LOADED", False)
    saved = (tladder.set_default_chain_mode(None), tladder.set_default_ladder(None))
    with tfi.inject(None), jfi.inject(None):
        tfi.clear_degradation_log()
        jfi.clear_degradation_log()
        yield path
    tfi.clear_degradation_log()
    jfi.clear_degradation_log()
    tladder.set_default_chain_mode(saved[0])
    tladder.set_default_ladder(saved[1])


def _k3():
    return np.outer([1, 2, 1], [1, 2, 1]).astype(np.float32) / 16


def _chains():
    M = [[0.99, -0.02, 3.5], [0.03, 1.01, -2.25]]
    return {
        "filter": ((jstencil.filter_stage(jnp.asarray(_k3())),),
                   (stencil.filter_stage(torch.from_numpy(_k3())),)),
        "erode": ((jstencil.erode_stage(3),), (stencil.erode_stage(3),)),
        "octave+pyrDown": (tuple(jfeatures.octave_chain(4, with_next_base=True)),
                           tuple(tfeatures.octave_chain(4, with_next_base=True))),
        "sobel pair": ((jstencil.sobel_stage(),), (stencil.sobel_stage(),)),
        "acceptance": ((jstencil.gaussian_stage(5), jstencil.erode_stage(1),
                        jstencil.threshold_stage(100.0)),
                       (stencil.gaussian_stage(5), stencil.erode_stage(1),
                        stencil.threshold_stage(100.0))),
        "preprocess": ((jstencil.gaussian_stage(5), jstencil.erode_stage(1),
                        jstencil.grad_stage()),
                       (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())),
        "warp": ((jstencil.warp_affine_stage(M, shape=(40, 48)),),
                 (stencil.warp_affine_stage(M, shape=(40, 48)),)),
    }


@pytest.mark.parametrize("name", list(_chains()))
def test_chain_signature_is_jax_string(name):
    jchain, tchain = _chains()[name]
    assert tat.chain_signature(tchain) == jat.chain_signature(jchain)


@pytest.mark.parametrize(
    "key,core",
    [
        ("sep_filter()tNonew5/5|8x512x512x3|uint8|auto|cpu",
         {"mode": "window", "times": {"window": 0.000122, "streaming": 0.000171}}),
        ("erode(3,)tNonew|2160x3840|uint8|r32c32|NVIDIA H100 80GB HBM3",
         {"mode": "streaming", "times": {"streaming": 1e-05}}),
        ("classify:gbdt:k250d128c10|256x32x128|float32|x|cpu",
         {"mode": "fused", "times": {"fused": 0.5, "ref": 2.0}}),
    ],
)
def test_seal_entry_checksum_is_jax(key, core):
    assert tat.seal_entry(key, core) == jat.seal_entry(key, core)
    assert tat.PLAN_SCHEMA_VERSION == jat.PLAN_SCHEMA_VERSION


def _table(n=4):
    return {f"chain{i}|8x8|uint8|auto|cpu": {"mode": "window", "times": {"window": 0.001 * (i + 1)}}
            for i in range(n)}


def _damage(kind: str, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    if kind == "bad json":
        path.write_text('{"chain0|8x8": {"mode": "window"')
        return
    sealed = {k: jat.seal_entry(k, v) for k, v in _table().items()}
    if kind == "one bad entry":
        sealed["chain1|8x8|uint8|auto|cpu"]["sum"] = "0" * 16
    elif kind == "schema version":
        for k in ("chain0|8x8|uint8|auto|cpu", "chain3|8x8|uint8|auto|cpu"):
            sealed[k]["v"] = 99
    elif kind == "not an object":
        path.write_text("[1, 2]")
        return
    path.write_text(json.dumps(sealed))


def _load(mod, path, spec=None):
    fi = tfi if mod is tat else jfi
    with warnings.catch_warnings(record=True) as caught, fi.inject(spec):
        warnings.simplefilter("always")
        got = mod.load_plan_table(str(path))
    quarantined = glob.glob(f"{path}.corrupt-*")
    kinds = {type(w.message).__name__ for w in caught}
    return got, len(quarantined), kinds, path.exists()


@pytest.mark.parametrize(
    "kind,spec",
    [("bad json", None), ("one bad entry", None), ("schema version", None),
     ("not an object", None), ("intact", "cache_corrupt")],
)
def test_load_plan_table_quarantines_like_jax(tmp_path, kind, spec):
    tpath, jpath = tmp_path / "t" / "table.json", tmp_path / "j" / "table.json"
    for p in (tpath, jpath):
        _damage(kind, p)
    got = _load(tat, tpath, spec)
    want = _load(jat, jpath, spec)
    assert got[0] == want[0]
    assert got[1] == want[1] == 1  # one quarantine file each
    assert got[2] == {"PlanTableWarning"} and want[2] == {"PlanTableWarning"}
    assert got[3] == want[3]
    # the surviving entries were written back sealed: a second load is clean
    if got[0]:
        assert tat.load_plan_table(str(tpath)) == got[0]
    assert [(e.stage, e.to_plan) for e in tfi.degradation_log()] == \
        [(e.stage, e.to_plan) for e in jfi.degradation_log()]


def test_save_load_round_trip_and_inspection_moves_no_file(tmp_path):
    path = tmp_path / "rt.json"
    assert tat.save_plan_table(_table(), str(path))
    assert json.loads(path.read_text()) == {k: jat.seal_entry(k, v) for k, v in _table().items()}
    assert tat.load_plan_table(str(path)) == _table()
    _damage("one bad entry", path)
    assert len(tat.load_plan_table(str(path), quarantine=False)) == 3
    assert not glob.glob(f"{path}.corrupt-*")


def _img(shape=(2, 40, 44, 3), dtype=np.float32, seed=0):
    x = np.random.default_rng(seed).random(shape) * 255
    return torch.from_numpy(x.astype(dtype))


def _plain_kernel_calls() -> dict:
    return {k: counters.PLAIN_CALLS[k] for k in ("stencil_chain", "stencil_stream")}


MODE_KERNEL = {"window": "stencil_chain", "streaming": "stencil_stream",
               "tiled2d": "stencil_stream"}


@pytest.mark.parametrize("winner", ["window", "tiled2d", "streaming"])
def test_mode_none_runs_the_cached_winner(cache_env, monkeypatch, winner):
    """measure_chain's entry routes mode=None to its winner's kernel (its
    plain version on the CPU), bit-equal to that mode; the winner is made
    certain by measuring it alone first, then measuring all candidates
    and checking the cache holds the fastest."""
    x = _img()
    chain = (stencil.gaussian_stage(5), stencil.erode_stage(1))
    entry = tat.measure_chain(x, chain, n=1, modes=(winner,))
    assert entry["mode"] == winner and set(entry["times"]) == {winner}
    assert tat.cached_chain_mode(chain, x.shape, x.dtype) == winner
    assert driver.fit_mode(chain, (6, 40, 44), torch.float32) == "streaming"
    counters.reset()
    got = stencil.fused_chain(x, chain)
    assert _plain_kernel_calls() == {
        k: int(k == MODE_KERNEL[winner]) for k in ("stencil_chain", "stencil_stream")}
    assert torch.equal(got, stencil.fused_chain(x, chain, mode=winner))
    # persisted sealed, and a read-back table routes the same way
    disk = json.loads(cache_env.read_text())
    (key,) = disk
    assert disk[key] == tat.seal_entry(key, entry)
    assert key.endswith(f"|2x40x44x3|float32|{tat.lc_tag(driver.DEFAULT)}|cpu")
    tat.clear_mode_cache()
    counters.reset()
    stencil.fused_chain(x, chain)  # no read-back: the fit rule (streaming)
    assert counters.PLAIN_CALLS["stencil_stream"] == 1 and counters.PLAIN_CALLS["stencil_chain"] == 0
    monkeypatch.setenv(tat.CACHE_READ_ENV, "1")
    tat.clear_mode_cache()
    counters.reset()
    stencil.fused_chain(x, chain)
    assert _plain_kernel_calls()["stencil_chain"] == int(winner == "window")


def test_measure_chain_caches_the_fastest_candidate(cache_env):
    x = _img()
    chain = (stencil.gaussian_stage(3),)
    entry = tat.measure_chain(x, chain, n=2, persist=False)
    assert set(entry["times"]) == {"streaming", "tiled2d", "window", "ref"}
    assert entry["mode"] == min(entry["times"], key=entry["times"].get)
    assert not cache_env.exists()  # persist=False writes no table
    assert tat.cached_chain_entry(chain, x.shape, x.dtype) == entry


def test_resolve_mode_order_default_then_cache_then_fit():
    x = _img()
    chain = (stencil.erode_stage(2),)
    planes = (6, 40, 44)
    assert driver.resolve_mode(chain, planes, x.dtype, img_shape=x.shape) == "streaming"
    tat.measure_chain(x, chain, n=1, modes=("tiled2d",), persist=False)
    assert driver.resolve_mode(chain, planes, x.dtype, img_shape=x.shape) == "tiled2d"
    assert driver.resolve_mode(chain, planes, x.dtype) == "streaming"  # another key
    tladder.set_default_chain_mode("window")
    assert driver.resolve_mode(chain, planes, x.dtype, img_shape=x.shape) == "window"


def test_a_cached_ref_never_routes_a_cuda_tensor(monkeypatch):
    """A table naming "ref" for a CUDA device (which measure_chain never
    writes) raises instead of running the plain version on the card."""
    monkeypatch.setattr(tat, "_device_name", lambda kind, index: f"{kind}-card")
    chain = (stencil.erode_stage(1),)
    key = tat._cache_key(chain, (1, 64, 64), torch.uint8, driver.DEFAULT, "cuda")
    tat._MODE_CACHE[key] = {"mode": "ref", "times": {"ref": 1.0}}
    with pytest.raises(ValueError, match="'ref' for a CUDA tensor"):
        driver.resolve_mode(chain, (1, 64, 64), torch.uint8, img_shape=(1, 64, 64), device="cuda")
    assert driver.resolve_mode(chain, (1, 64, 64), torch.uint8, device="cpu") == "streaming"


def test_a_default_ref_mode_never_routes_a_cuda_tensor():
    """`set_default_chain_mode("ref")` forces the plain version on the CPU
    only; on a CUDA device it raises before any kernel or plain version."""
    chain = (stencil.erode_stage(1),)
    tladder.set_default_chain_mode("ref")
    with pytest.raises(ValueError, match="'ref' for a CUDA tensor"):
        driver.resolve_mode(chain, (1, 64, 64), torch.uint8, device="cuda")
    assert driver.resolve_mode(chain, (1, 64, 64), torch.uint8, device="cpu") == "ref"
    tladder.set_default_chain_mode("window")
    assert driver.resolve_mode(chain, (1, 64, 64), torch.uint8, device="cuda") == "window"


def test_a_card_plan_resolves_fused_without_the_cache(cache_env, monkeypatch):
    """A plan on a CUDA device takes "fused" for mode=None even where the
    table names "ref", and refuses a ladder that moves to "ref" (a stub
    device check, no card)."""
    plan, descs, valids = _svm_plan()
    tat.measure_classify(plan, descs, valids, n=1, modes=("ref",), persist=False)
    assert plan.resolve_mode(descs.shape, descs.dtype) == "ref"
    monkeypatch.setattr(tclassify.ClassifyPlan, "on_card", property(lambda self: True))
    assert plan.resolve_mode(descs.shape, descs.dtype) == "fused"
    laddered, _, _ = _svm_plan(ladder=tclassify.CLASSIFY_LADDER)
    counters.reset()
    with pytest.raises(ValueError, match="moves to 'ref'"):
        laddered.histograms(descs, valids)
    assert sum(counters.PLAIN_CALLS.values()) == 0


def test_ref_is_no_candidate_on_the_card(monkeypatch):
    """With the device check stubbed to say "card" (no card here): naming
    "ref" raises before anything runs, and the default candidates are the
    kernel modes, streaming only where its rings fit."""
    monkeypatch.setattr(tat, "_is_card", lambda t: True)
    x = _img()
    chain = (stencil.gaussian_stage(5),)
    counters.reset()
    for modes in (("ref",), ("window", "ref")):
        with pytest.raises(ValueError, match="no candidate on the card"):
            tat.measure_chain(x, chain, modes=modes)
    assert sum(counters.PLAIN_CALLS.values()) == 0
    assert tat.chain_candidates(x, chain) == ("streaming", "tiled2d", "window")
    wide = torch.empty((2160, 3840), dtype=torch.float32)
    k13 = (stencil.filter_stage(torch.ones((13, 13)) / 169),)
    assert driver.fit_mode(k13, (1, 2160, 3840), torch.float32) == "tiled2d"
    assert tat.chain_candidates(wide, k13) == ("tiled2d", "window")
    plan, descs, valids = _svm_plan()
    with pytest.raises(ValueError, match="no candidate on the card"):
        tat.measure_classify(plan, descs, valids, modes=("ref",))


def test_ref_is_a_cpu_candidate_and_unknown_modes_raise():
    x = _img()
    chain = (stencil.gaussian_stage(5),)
    assert tat.chain_candidates(x, chain) == ("streaming", "tiled2d", "window", "ref")
    with pytest.raises(ValueError, match="unknown mode"):
        tat.measure_chain(x, chain, modes=("fast",))
    with pytest.raises(ValueError, match="no candidate"):
        tat.measure_chain(x, chain, modes=())


def test_measure_timeout_and_deadline(cache_env):
    x = _img()
    chain = (stencil.erode_stage(1),)
    with tfi.inject("measure_timeout:count=1"), pytest.raises(tat.MeasureTimeout):
        tat.measure_chain(x, chain)
    entry = tat.measure_chain(x, chain, n=1, deadline_s=0.0, persist=False)
    assert list(entry["times"]) == ["streaming"]  # the first candidate always runs
    (ev,) = tfi.degradation_log()
    assert (ev.stage, ev.from_plan, ev.to_plan) == (
        "measure_chain", "tiled2d+window+ref", "measured-subset")


def test_measure_pyramid_measures_every_link_and_routes_each():
    """Every link is measured (the port launches links no larger than their
    halo too; JAX records those as untimed ref fallbacks), and
    `chained_launches(mode=None)` then runs each link's winner."""
    g = _img((1, 72, 80, 1), seed=3)
    chains = tfeatures.pyramid_chains(3)
    entries = tat.measure_pyramid(g, chains, n=1, modes=("window", "tiled2d"), persist=False)
    assert len(entries) == 3 and not any("fallback" in e for e in entries)
    assert all(set(e["times"]) == {"window", "tiled2d"} for e in entries)
    want = {"stencil_chain": 0, "stencil_stream": 0}
    for e in entries:
        want[MODE_KERNEL[e["mode"]]] += 1
    counters.reset()
    outs, _ = stencil.chained_launches(g, chains)
    assert _plain_kernel_calls() == want
    # the last link's planes (18x20) are no larger than its halo, and are measured
    ph, _ = stencil.chain_accumulated_halo(chains[-1])
    assert outs[-1][0].shape[1] <= ph


def _svm_plan(ladder=None):
    rng = np.random.default_rng(4)
    K, D, C = 9, 16, 4
    plan = tclassify.ClassifyPlan(
        torch.from_numpy(rng.random((K, D)).astype(np.float32)), C,
        w=torch.from_numpy(rng.standard_normal((C, K)).astype(np.float32)),
        b=torch.from_numpy(rng.standard_normal(C).astype(np.float32)), ladder=ladder)
    descs = torch.from_numpy(rng.random((6, 5, D)).astype(np.float32))
    valids = torch.from_numpy(rng.random((6, 5)) < 0.7)
    return plan, descs, valids


def test_classify_mode_none_runs_the_measured_winner(cache_env):
    plan, descs, valids = _svm_plan()
    assert plan.signature == "classify:svm:k9d16c4"
    assert plan.resolve_mode(descs.shape, descs.dtype) == "fused"
    entry = tat.measure_classify(plan, descs, valids, n=1, modes=("ref",))
    assert entry["mode"] == "ref"
    assert tat.cached_classify_mode(plan, descs.shape, descs.dtype) == "ref"
    counters.reset()
    plan.histograms(descs, valids)  # the cached ref: the plain histograms, no kernel wrapper
    assert counters.PLAIN_CALLS["bow_quantize_hist"] == 1
    entry = tat.measure_classify(plan, descs, valids, n=1)
    assert set(entry["times"]) == {"fused", "ref"}
    assert (tat.cached_classify_mode(plan, descs.shape, descs.dtype) ==
            min(entry["times"], key=entry["times"].get))
    assert len(json.loads(cache_env.read_text())) == 1


def test_show_cache_prints_the_table(cache_env):
    x = _img()
    tat.measure_chain(x, (stencil.erode_stage(1),), n=1, modes=("window",))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-m", "repro_torch.core.autotune", "--show-cache"],
                         capture_output=True, text=True, env=env, check=True, timeout=120).stdout
    assert f"# chain-mode autotune cache: {cache_env}" in out
    assert "erode(1,)tNonew|2x40x44x3|float32|" in out and "-> window" in out


class ScriptedWatchdog:
    """Records each ``step(i, seconds)`` and flags the steps in `slow`."""

    def __init__(self, slow=()):
        self.slow, self.steps = set(slow), []

    def step(self, i, seconds):
        self.steps.append((i, seconds))
        return i in self.slow


@pytest.mark.parametrize("slow", [(), (2,), (0, 3), (1, 2, 3)])
def test_measure_chain_feeds_the_watchdog_as_jax(slow):
    """One step a timed candidate, timed from its start, and a straggler
    recorded as a measure_chain event from the mode to itself.  At 32x32 JAX
    times all four modes (its planes no larger than the octave's halo run
    `chain_ref` under each), as the port does on the CPU when asked for
    them (its default leaves out streaming here: the fit rule)."""
    x = np.random.default_rng(2).random((32, 32), dtype=np.float32)
    evs, steps = {}, {}
    for side, at, fi, feats, img in (
        ("torch", tat, tfi, tfeatures, torch.from_numpy(x)),
        ("jax", jat, jfi, jfeatures, jnp.asarray(x)),
    ):
        wd = ScriptedWatchdog(slow)
        with fi.collect_events() as e:
            entry = at.measure_chain(img, feats.octave_chain(with_next_base=False), n=1,
                                     modes=jat.CHAIN_MODES, persist=False, watchdog=wd)
        # (JAX also records its structural chain_ref fallbacks, stage fused_chain)
        evs[side] = [(v.stage, v.from_plan, v.to_plan, v.reason, v.injected) for v in e
                     if v.stage == "measure_chain"]
        steps[side] = [i for i, _ in wd.steps]
        assert all(s >= 0.0 for _, s in wd.steps)
        assert len(wd.steps) == len(entry["times"]) == 4
    assert steps["torch"] == steps["jax"] == [0, 1, 2, 3]
    assert evs["torch"] == evs["jax"]
    assert [e[1] for e in evs["torch"]] == [("streaming", "tiled2d", "window", "ref")[i]
                                             for i in sorted(slow)]


def test_measure_chain_watchdog_skips_untimed_candidates():
    """A candidate cut by the deadline gets no step; a real watchdog in its
    warm-up flags nothing."""
    x = torch.from_numpy(np.random.default_rng(3).random((32, 32), dtype=np.float32))
    wd = ScriptedWatchdog()
    tat.measure_chain(x, tfeatures.octave_chain(with_next_base=False), n=1, persist=False,
                      deadline_s=0.0, watchdog=wd)
    assert [i for i, _ in wd.steps] == [0]
    from repro_torch.train.fault import StragglerWatchdog

    real = StragglerWatchdog(threshold=4.0, warmup=10)
    with tfi.collect_events() as e:
        tat.measure_chain(x, tfeatures.octave_chain(with_next_base=False), n=1, persist=False,
                          watchdog=real)
    assert real.n == 3 and not real.alarms  # tiled2d, window, ref and not [v for v in e if "straggler" in v.reason]
