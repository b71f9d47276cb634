"""The port's GBDT head against the JAX package's, on the CPU.

On the CPU the port's `gbdt_score` runs its plain version; the JAX side
runs its Pallas kernel in interpret mode (``VectorConfig(lmul=1)``), as
its own tests do, and its staged oracles.

Rules, with their reasons:
  * leaf indices are exact: both sides compare the same f32 values;
  * scores agree at rtol 1e-5 / atol 1e-5, the JAX package's own tolerance
    (tests/test_kernels_gbdt.py): the leaf values are summed in another
    order;
  * `_level_split` picks the same (feature, threshold, bits) exactly;
  * `gbdt_train`: `feat` exact, `thr` at rtol 1e-6, `leaf` and `base` at
    rtol 1e-4 / atol 1e-5, since residual means over 16 trees are summed
    in another order (the `svm_train` rule).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig
from repro.cv import gbdt as jgbdt
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.cv import gbdt as tgbdt
from repro_torch.kernels import counters
from repro_torch.kernels import gbdt as kgbdt
from repro_torch.kernels import ref as tref

VC = VectorConfig(lmul=1)


def _model(seed, *, n_trees=6, depth=3, n_feat=40, n_classes=5):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n_feat, (n_trees, depth)).astype(np.int32),
        rng.standard_normal((n_trees, depth)).astype(np.float32),
        rng.standard_normal((n_trees, 2**depth, n_classes)).astype(np.float32),
        rng.standard_normal(n_classes).astype(np.float32),
    )


def _both(x, model):
    feat, thr, leaf, base = model
    js, jli = jops.gbdt_score(jnp.asarray(x), *(jnp.asarray(a) for a in model), vc=VC)
    ts, tli = kgbdt.gbdt_score(torch.from_numpy(x), *(torch.from_numpy(a) for a in model))
    return (np.asarray(js), np.asarray(jli)), (ts.numpy(), tli.numpy())


@pytest.mark.parametrize(
    "b,depth,n_trees,n_classes", [(17, 3, 6, 5), (64, 2, 6, 5), (256, 3, 16, 10)]
)
def test_gbdt_score_matches_jax_kernel(b, depth, n_trees, n_classes):
    model = _model(b + depth, n_trees=n_trees, depth=depth, n_classes=n_classes)
    x = np.random.default_rng(b).standard_normal((b, 40)).astype(np.float32)
    (js, jli), (ts, tli) = _both(x, model)
    assert ts.dtype == np.float32 and tli.dtype == np.int32
    np.testing.assert_array_equal(tli, jli)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_gbdt_threshold_boundary_goes_left():
    """x == thr must go left (strict >) on both sides."""
    feat, thr, leaf, base = _model(3, n_trees=3, depth=2, n_feat=8)
    x = np.zeros((4, 8), np.float32)
    for t in range(3):
        for lvl in range(2):
            x[:, feat[t, lvl]] = thr[t, lvl]
    (_, jli), (_, tli) = _both(x, (feat, thr, leaf, base))
    np.testing.assert_array_equal(tli, jli)
    want = np.asarray(jref.gbdt_leaf_ref(jnp.asarray(x), jnp.asarray(feat), jnp.asarray(thr)))
    np.testing.assert_array_equal(tli, want)


def test_gbdt_score_rejects_wrong_leaf_count():
    feat, thr, leaf, base = _model(4, depth=3)
    args = [torch.from_numpy(a) for a in (feat, thr, leaf[:, :5], base)]
    with pytest.raises(ValueError, match="leaf"):
        kgbdt.gbdt_score(torch.zeros((4, 40)), *args)


def test_gbdt_refs_match_jax():
    model = _model(5)
    feat, thr, leaf, base = model
    x = np.random.default_rng(5).standard_normal((33, 40)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, tm = [jnp.asarray(a) for a in model], [torch.from_numpy(a) for a in model]
    np.testing.assert_array_equal(
        tref.gbdt_leaf_ref(tx, tm[0], tm[1]).numpy(),
        np.asarray(jref.gbdt_leaf_ref(jx, jm[0], jm[1])),
    )
    np.testing.assert_allclose(
        tref.gbdt_scores_ref(tx, *tm).numpy(),
        np.asarray(jref.gbdt_scores_ref(jx, *jm)),
        rtol=1e-5,
        atol=1e-5,
    )


def test_bow_histogram_ref_matches_jax():
    assign = np.random.default_rng(6).integers(0, 9, 50).astype(np.int32)
    for normalize in (True, False):
        got = tref.bow_histogram_ref(torch.from_numpy(assign), 9, normalize=normalize)
        want = jref.bow_histogram_ref(jnp.asarray(assign), 9, normalize=normalize)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_version_sums_trees_in_order_then_base():
    feat, thr, leaf, base = _model(7, n_trees=5, depth=2, n_feat=6, n_classes=3)
    x = np.random.default_rng(7).standard_normal((9, 6)).astype(np.float32)
    li = np.asarray(jref.gbdt_leaf_ref(jnp.asarray(x), jnp.asarray(feat), jnp.asarray(thr)))
    want = np.zeros((9, 3), np.float32)
    for i in range(9):
        acc = leaf[0, li[i, 0]].copy()
        for t in range(1, 5):
            acc = (acc + leaf[t, li[i, t]]).astype(np.float32)
        want[i] = acc + base
    counters.reset()
    got, _ = kgbdt.gbdt_score(torch.from_numpy(x), *(torch.from_numpy(a) for a in (feat, thr, leaf, base)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert counters.PLAIN_CALLS["gbdt_score"] == 1 and counters.LAUNCHES["gbdt_score"] == 0


def _blobs(seed, n=120, n_classes=4, n_feat=16):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n).astype(np.int32)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    x[np.arange(n), y * 3] += 4.0
    return x, y


def test_level_split_matches_jax():
    x, y = _blobs(8)
    rng = np.random.default_rng(8)
    r = (np.eye(4, dtype=np.float32)[y] - 0.25).astype(np.float32)
    pid = rng.integers(0, 2, len(y)).astype(np.int32)
    qs = np.linspace(0.0, 1.0, 10, dtype=np.float32)[1:-1]
    thresholds = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(qs), axis=0)).T.copy()
    jf, jt, jb = jgbdt._level_split(jnp.asarray(x), jnp.asarray(r), jnp.asarray(pid), 2,
                                    jnp.asarray(thresholds))
    tf, tt, tb = tgbdt._level_split(torch.from_numpy(x), torch.from_numpy(r),
                                    torch.from_numpy(pid), 2, torch.from_numpy(thresholds))
    assert int(tf) == int(jf)
    assert float(tt) == float(jt)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("n_trees,depth", [(16, 3), (4, 2)])
def test_gbdt_train_matches_jax(n_trees, depth):
    x, y = _blobs(9)
    want = jgbdt.gbdt_train(jnp.asarray(x), jnp.asarray(y), n_classes=4, n_trees=n_trees,
                            depth=depth)
    got = tgbdt.gbdt_train(torch.from_numpy(x), torch.from_numpy(y), n_classes=4,
                           n_trees=n_trees, depth=depth)
    assert got.feat.dtype == torch.int32 and got.n_classes == 4
    np.testing.assert_array_equal(got.feat.numpy(), np.asarray(want.feat))
    np.testing.assert_allclose(got.thr.numpy(), np.asarray(want.thr), rtol=1e-6)
    for k in ("leaf", "base"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-4, atol=1e-5)
    pred = tgbdt.gbdt_predict_ref(got, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(pred, np.asarray(jgbdt.gbdt_predict_ref(want, jnp.asarray(x))))
    assert (pred == y).mean() > 0.7


def _gbdt_consts() -> dict:
    """The kernel's constexprs, read from csrc/gbdt.cu."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "gbdt.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def gbdt_warp_replay(x, feat, thr, leaf, base):
    """numpy replay of csrc/gbdt.cu's walk: blocks of kWarps rows, one warp a
    row, each of its 32 lanes a vector entry.  Per chunk of 32 classes (one
    pass when C <= 32), per chunk of 32 trees: lane t gathers kLevels levels
    at a time and packs tree t0 + t's leaf index (-1 for a feature outside
    [0, F)); lane c then takes leaf index j of the chunk from lane j (the
    shuffle), loads kLeaves leaf values at a time, and adds them in ascending
    t, the first tree's value as the start; the base last.  Leaf indices are
    written in the first class pass only.  Float sums are float32 numpy
    adds, rounded one by one like ``__fadd_rn``."""
    k = _gbdt_consts()
    warps, levels, leaves = k["kWarps"], k["kLevels"], k["kLeaves"]
    B, F = x.shape
    T, depth = feat.shape
    C = leaf.shape[2]
    scores = np.full((B, C), -7.0, np.float32)  # sentinels: every entry must be written
    lidx = np.full((B, T), -7, np.int32)
    lanes = np.arange(32)
    class_chunks = (C + 31) // 32 if C > 32 else 1
    for blk in range(-(-B // warps)):
        for w in range(warps):
            row = blk * warps + w
            if row >= B:
                continue
            xr = x[row]
            for cc in range(class_chunks):
                c = cc * 32 + lanes
                has_c = c < C
                acc = np.zeros(32, np.float32)
                for t0 in range(0, T, 32):
                    li = np.zeros(32, np.int64)
                    for lane in range(32):
                        t = t0 + lane
                        if t >= T:
                            continue
                        v, bad = 0, False
                        for l0 in range(0, depth, levels):
                            ls = [l0 + u for u in range(levels) if l0 + u < depth]
                            fs = [int(feat[t, lv]) for lv in ls]
                            ok = [0 <= f < F for f in fs]
                            bad |= not all(ok)
                            xv = [xr[f] if o else np.float32(0) for f, o in zip(fs, ok)]
                            for lv, xval in zip(ls, xv):
                                if xval > thr[t, lv]:
                                    v |= 1 << lv
                        li[lane] = -1 if bad else v
                        if cc == 0:
                            lidx[row, t] = li[lane]
                    nt = min(32, T - t0)
                    for j0 in range(0, nt, leaves):
                        vals = np.full((leaves, 32), np.nan, np.float32)
                        for u in range(leaves):
                            j = j0 + u
                            lj = li[j & 31]  # __shfl_sync from lane j
                            if j < nt and lj >= 0:
                                vals[u, has_c] = leaf[t0 + j, lj, c[has_c]]
                        for u in range(leaves):
                            if j0 + u < nt:
                                acc = vals[u].copy() if t0 + j0 + u == 0 else acc + vals[u]
                scores[row, c[has_c]] = acc[has_c] + base[c[has_c]]
    return scores, lidx


def _boundary_model(seed, B, F, T, depth, C):
    """A random model and x in (0, 1), with x == thr at every level of the
    first trees in the first rows (those levels go left)."""
    rng = np.random.default_rng(seed)
    feat = rng.integers(0, F, (T, depth)).astype(np.int32)
    thr = rng.random((T, depth)).astype(np.float32)
    leaf = rng.standard_normal((T, 2**depth, C)).astype(np.float32)
    base = rng.standard_normal(C).astype(np.float32)
    x = rng.random((B, F)).astype(np.float32)
    for t in range(min(T, 3)):
        for lv in range(depth):
            x[: min(B, 2), feat[t, lv]] = thr[t, lv]
    return x, feat, thr, leaf, base


@pytest.mark.parametrize(
    "B,F,T,depth,C",
    [
        (9, 40, 40, 3, 33),  # trees and classes past one chunk of 32
        (1, 12, 1, 1, 1),
        (7, 30, 33, 9, 5),  # depth past kLevels: two gather rounds
        (6, 20, 64, 2, 65),  # two tree chunks, three class chunks
        (5, 250, 16, 3, 10),  # the predict head's model, B not a multiple of kWarps
        (4, 10, 0, 2, 3),  # no trees: scores are the base
        (3, 10, 5, 2, 0),  # no classes: leaf indices still written
        (2, 16, 13, 8, 32),  # exactly one class chunk
    ],
)
def test_warp_replay_is_bit_equal_to_plain(B, F, T, depth, C):
    x, feat, thr, leaf, base = _boundary_model(B * 131 + T, B, F, T, depth, C)
    got_s, got_li = gbdt_warp_replay(x, feat, thr, leaf, base)
    want_s, want_li = kgbdt.gbdt_score_plain(
        *(torch.from_numpy(a) for a in (x, feat, thr, leaf, base))
    )
    np.testing.assert_array_equal(got_li, want_li.numpy())
    assert got_s.dtype == np.float32
    np.testing.assert_array_equal(got_s, want_s.numpy())


def test_warp_replay_marks_out_of_range_features():
    """The kernel's own contract past the plain version (which raises): a
    feature outside [0, F) is never read, its tree's index is -1 and the
    row's scores NaN; other rows' trees are unaffected."""
    x, feat, thr, leaf, base = _boundary_model(5, 3, 8, 4, 2, 3)
    feat[2, 1] = 8
    s, li = gbdt_warp_replay(x, feat, thr, leaf, base)
    assert (li[:, 2] == -1).all() and (li[:, [0, 1, 3]] >= 0).all()
    assert np.isnan(s).all()


def test_kernel_geometry_and_launch_without_shared_memory():
    """One warp a row (`ROWS_PER_BLOCK` rows a block is the source's
    kWarps), 32 lanes per chunk, and nothing that a model's size could
    overflow: no shared memory and no `cudaFuncSetAttribute`."""
    from repro_torch.kernels import _build

    k = _gbdt_consts()
    assert k["kWarps"] == kgbdt.ROWS_PER_BLOCK
    assert k["kLevels"] >= 1 and k["kLeaves"] >= 1 and 32 % k["kLeaves"] == 0
    src = (_build.CSRC / "gbdt.cu").read_text()
    assert "__shared__" not in src and "cudaFuncSetAttribute" not in src
    assert "__syncthreads" not in src
    # 256 rows take 64 blocks: one wave on 132 SMs
    assert -(-256 // kgbdt.ROWS_PER_BLOCK) == 64
