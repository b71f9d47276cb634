"""The port's BoW kernels against the JAX package's.

On the CPU the port's `bow_assign`, `bow_quantize_hist` and `linear_score`
run their plain versions; the JAX side runs its Pallas kernels in interpret mode, as the
JAX package's own tests do, and its staged oracles.

Rules, with their reasons:
  * histograms are exact except at near-ties: the two sides sum the
    D-long dot products in different orders, so where the best and
    second-best s = -2 d.c + |c|^2 lie within 4 ulp the word may differ.
    Such descriptors are counted (from an f64 recomputation) and only
    images that hold one may differ, by at most one count move each;
  * `bow_assign` word indices follow the same rule, one descriptor at a
    time; its d2 = min s + |d|^2 agrees at rtol 1e-5;
  * scores agree at 1e-6: the sum over K is ordered differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.vector import VectorConfig
from repro.kernels import bow as jbow
from repro.kernels import ref as jref

from repro_torch.kernels import bow as tbow
from repro_torch.kernels import counters
from repro_torch.kernels import ref as tref

VC = VectorConfig(lmul=1)


def near_ties(descs: np.ndarray, cents: np.ndarray, ulps: int = 4) -> np.ndarray:
    """(B, N) mask of descriptors whose best and second-best s lie within
    `ulps` f32 ulps of each other (s recomputed in f64)."""
    d = descs.astype(np.float64)
    c = cents.astype(np.float64)
    s = -2.0 * d @ c.T + np.sum(c * c, axis=1)
    part = np.sort(s, axis=-1)[..., :2]
    gap = part[..., 1] - part[..., 0]
    return gap <= ulps * np.spacing(np.abs(part[..., 0]).astype(np.float32))


def assert_hist_near_tie_rule(got, want, descs, valids, cents):
    """Unnormalised (B, K) counts: rows without a valid near-tie descriptor
    are exact; a row with t of them differs by at most 2t in L1."""
    ties = near_ties(descs, cents) & (valids > 0)
    per_image = ties.sum(axis=1)
    l1 = np.abs(got - want).sum(axis=1)
    assert np.all(l1 <= 2 * per_image), (l1, per_image)
    return int(ties.sum())


def _problem(seed, B, N, D, K, p_valid=0.8):
    rng = np.random.default_rng(seed)
    descs = rng.standard_normal((B, N, D)).astype(np.float32)
    cents = rng.standard_normal((K, D)).astype(np.float32)
    valids = rng.random((B, N)) < p_valid
    return descs, valids, cents


@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (2, 40, 128, 7), (4, 5, 16, 130)])
def test_quantize_hist_matches_jax_kernel(B, N, D, K):
    descs, valids, cents = _problem(B * N + K, B, N, D, K)
    want = np.asarray(jbow.bow_quantize_hist(jnp.asarray(descs), jnp.asarray(valids),
                                             jnp.asarray(cents), vc=VC, normalize=False))
    got = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                                 torch.from_numpy(cents), normalize=False).numpy()
    assert got.shape == want.shape == (B, K)
    n_ties = assert_hist_near_tie_rule(got, want, descs, valids, cents)
    assert n_ties == 0  # random data: a near-tie here would be a one-in-a-million event


@pytest.mark.parametrize("normalize", [True, False])
def test_quantize_hist_matches_jax_oracle(normalize):
    descs, valids, cents = _problem(7, 3, 32, 128, 50)
    want = np.asarray(jref.bow_hist_ref(jnp.asarray(descs), jnp.asarray(valids),
                                        jnp.asarray(cents), normalize=normalize))
    got = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                                 torch.from_numpy(cents), normalize=normalize).numpy()
    np.testing.assert_array_equal(got, want)
    tref_h = tref.bow_hist_ref(torch.from_numpy(descs), torch.from_numpy(valids),
                               torch.from_numpy(cents), normalize=normalize).numpy()
    np.testing.assert_array_equal(tref_h, want)


def test_pad_centroids_never_win():
    """Every real word scores s > 0 (far from the descriptors); the JAX
    kernel pads K=5 to 128 words with |c|^2 = +inf, and the port's kernel
    pads its last codebook tile the same way.  A zero pad word left
    unmasked would score s = 0 and win."""
    rng = np.random.default_rng(1)
    descs = rng.standard_normal((2, 8, 16)).astype(np.float32)
    cents = (10.0 + rng.random((5, 16))).astype(np.float32)
    valids = np.ones((2, 8), bool)
    want = np.asarray(jbow.bow_quantize_hist(jnp.asarray(descs), jnp.asarray(valids),
                                             jnp.asarray(cents), vc=VC, normalize=False))
    got = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                                 torch.from_numpy(cents), normalize=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 16


def test_ties_go_to_the_lowest_word():
    """Duplicate words give bit-identical s; both sides pick the lower index."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((4, 32)).astype(np.float32)
    cents = np.concatenate([base, base[::-1]])          # word k+4 duplicates word 3-k
    descs = (base[None] + 0.01 * rng.standard_normal((3, 4, 32))).astype(np.float32)
    valids = np.ones((3, 4), bool)
    want = np.asarray(jbow.bow_quantize_hist(jnp.asarray(descs), jnp.asarray(valids),
                                             jnp.asarray(cents), vc=VC, normalize=False))
    got = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                                 torch.from_numpy(cents), normalize=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, 4:] == 0) and np.all(got[:, :4] == 1)


def test_empty_and_invalid_descriptors():
    descs, _, cents = _problem(3, 2, 6, 8, 5)
    valids = np.zeros((2, 6), bool)
    got = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                                 torch.from_numpy(cents)).numpy()
    np.testing.assert_array_equal(got, np.zeros((2, 5), np.float32))


@pytest.mark.parametrize("B,K,C", [(5, 250, 10), (33, 17, 3)])
def test_linear_score_matches_jax(B, K, C):
    rng = np.random.default_rng(B + K + C)
    h = rng.random((B, K)).astype(np.float32)
    h /= h.sum(axis=1, keepdims=True)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(jbow.linear_score(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), vc=VC))
    got = tbow.linear_score(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ref = tref.svm_decision_ref(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref.svm_decision_ref(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))), rtol=1e-6, atol=1e-6)


def test_plain_versions_sum_in_index_order():
    """The plain versions round after every product and sum, in ascending
    index order: the order the CUDA kernels keep."""
    rng = np.random.default_rng(4)
    h = rng.random((3, 9)).astype(np.float32)
    w = rng.standard_normal((2, 9)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    want = np.zeros((3, 2), np.float32)
    for i in range(3):
        for c in range(2):
            acc = np.float32(h[i, 0] * w[c, 0])
            for k in range(1, 9):
                acc = np.float32(acc + np.float32(h[i, k] * w[c, k]))
            want[i, c] = np.float32(acc + b[c])
    got = tbow.linear_score_plain(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B", [1, 7, 256, 1000])
def test_linear_score_tile_geometry(B):
    """The kernel's tiles: one block per 16 images and 32 classes, K staged
    whole when the rows of h and w fit 48 KB (the predict shape, K = 250,
    C = 10: 16 blocks for a request of 256), in chunks otherwise; a numpy
    replay of that walk (each output's sum carried from chunk to chunk in
    ascending k, from -0) equals the plain version bit for bit."""
    g = tbow.score_geometry(B, 250, 10)
    assert g["blocks"] == (-(-B // 16), 1) and g["kc"] == 250
    assert g["smem"] == 4 * (16 * 32 + (16 + 10) * 251) <= tbow.SCORE_SMEM
    K, C = 257, 33
    g = tbow.score_geometry(B, K, C)
    assert g["blocks"] == (-(-B // 16), 2) and g["kc"] == 244
    assert g["smem"] == 4 * (16 * 32 + (16 + 32) * 245) <= tbow.SCORE_SMEM
    rng = np.random.default_rng(B)
    h = rng.random((B, K)).astype(np.float32)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    got = np.full((B, C), np.nan, np.float32)
    for bi in range(g["blocks"][0]):
        for ci in range(g["blocks"][1]):
            rows = slice(16 * bi, min(16 * bi + 16, B))
            cls = slice(32 * ci, min(32 * ci + 32, C))
            acc = np.full((rows.stop - rows.start, cls.stop - cls.start), -0.0, np.float32)
            for k0 in range(0, K, g["kc"]):
                for k in range(k0, min(k0 + g["kc"], K)):
                    acc = acc + h[rows, k, None] * w[None, cls, k]
            got[rows, cls] = acc + b[cls]
    want = tbow.linear_score_plain(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(got, want.numpy())


def test_bow_assign_ref_matches_jax():
    rng = np.random.default_rng(5)
    d = rng.standard_normal((64, 16)).astype(np.float32)
    c = rng.standard_normal((9, 16)).astype(np.float32)
    ji, jd2 = jref.bow_assign_ref(jnp.asarray(d), jnp.asarray(c))
    ti, td2 = tref.bow_assign_ref(torch.from_numpy(d), torch.from_numpy(c))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_count_plain_calls():
    descs, valids, cents = _problem(6, 2, 4, 8, 3)
    counters.reset()
    h = tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(valids),
                               torch.from_numpy(cents))
    tbow.linear_score(h, torch.zeros((2, 3)), torch.zeros(2))
    assert counters.PLAIN_CALLS == {
        "stencil_chain": 0,
        "stencil_stream": 0,
        "bow_quantize_hist": 1,
        "linear_score": 1,
        "bow_assign": 0,
        "gbdt_score": 0,
        "flash_attention": 0,
        "seed_gaussian_blur": 0,
        "seed_erode": 0,
        "seed_threshold": 0,
    }
    assert sum(counters.LAUNCHES.values()) == 0


def assert_assign_near_tie_rule(got_idx, want_idx, descs, cents):
    """Word indices are equal wherever the best and second-best s are not a
    near-tie; returns how many near-ties there were."""
    ties = near_ties(descs, cents)
    np.testing.assert_array_equal(got_idx[~ties], want_idx[~ties])
    return int(ties.sum())


@pytest.mark.parametrize("shape,K", [((200, 128), 250), ((3, 32, 128), 250), ((45, 16), 33)])
def test_bow_assign_matches_jax_kernel(shape, K):
    rng = np.random.default_rng(sum(shape) + K)
    desc = rng.standard_normal(shape).astype(np.float32)
    cents = rng.standard_normal((K, shape[-1])).astype(np.float32)
    ji, jd2 = jbow.bow_assign(jnp.asarray(desc), jnp.asarray(cents), vc=VC)
    counters.reset()
    ti, td2 = tbow.bow_assign(torch.from_numpy(desc), torch.from_numpy(cents))
    assert counters.PLAIN_CALLS["bow_assign"] == 1 and counters.LAUNCHES["bow_assign"] == 0
    assert ti.shape == td2.shape == shape[:-1]
    assert ti.dtype == torch.int32 and td2.dtype == torch.float32
    n_ties = assert_assign_near_tie_rule(ti.numpy(), np.asarray(ji), desc, cents)
    assert n_ties == 0  # random data: a near-tie here would be a one-in-a-million event
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)


def test_bow_assign_ties_pads_and_empty():
    """Duplicate words go to the lower index, the last tile's pad rows never
    win (every real s > 0), and N = 0 gives empty outputs without a call."""
    rng = np.random.default_rng(10)
    base = (rng.random((4, 32)) + 1.0).astype(np.float32)
    cents = np.concatenate([base, base[::-1]])
    desc = -base
    ji, jd2 = jbow.bow_assign(jnp.asarray(desc), jnp.asarray(cents), vc=VC)
    ti, td2 = tbow.bow_assign(torch.from_numpy(desc), torch.from_numpy(cents))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.all(ti.numpy() < 4)  # word k + 4 duplicates word 3 - k
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-5)
    counters.reset()
    ei, ed2 = tbow.bow_assign(torch.zeros((0, 32)), torch.from_numpy(cents))
    ji, jd2 = jbow.bow_assign(jnp.zeros((0, 32)), jnp.asarray(cents), vc=VC)
    assert ei.shape == ed2.shape == tuple(ji.shape) == (0,)
    assert ei.dtype == torch.int32 and ed2.dtype == torch.float32
    assert counters.PLAIN_CALLS["bow_assign"] == 0


def test_bow_assign_plain_is_the_quantize_argmin():
    """Assignment and quantize + histogram share one argmin: the histogram
    of bow_assign's words is the quantize kernel's plain histogram."""
    descs, valids, cents = _problem(11, 3, 20, 64, 40)
    idx, _ = tbow.bow_assign(torch.from_numpy(descs), torch.from_numpy(cents))
    h = torch.zeros((3, 40)).scatter_add_(1, idx.long(), torch.from_numpy(valids).float())
    want = tbow.quantize_hist_plain(torch.from_numpy(descs), torch.from_numpy(valids),
                                    torch.from_numpy(cents))
    np.testing.assert_array_equal(h.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The micro-tiled nearest-word search of csrc/bow.cu, replayed in numpy
# ---------------------------------------------------------------------------

def _seq_dot(a, b):
    """a (M, D) . b (K, D)^T summed over D in ascending order from -0, every
    product and sum rounded to f32 (the kernel's register chains)."""
    acc = np.full((a.shape[0], b.shape[0]), -0.0, np.float32)
    for q in range(a.shape[1]):
        acc = acc + a[:, q:q + 1] * b[:, q][None, :]
    return acc


def _seq_sq(x):
    acc = np.full(x.shape[0], -0.0, np.float32)
    for q in range(x.shape[1]):
        acc = acc + x[:, q] * x[:, q]
    return acc


def _replay_search(desc, cents):
    """`nearest_words` over rows of `desc` (M, D): blocks of SEARCH_ROWS rows
    zero-filled past M, codebook tiles of SEARCH_WORDS words zero-filled past
    K with |c|^2 = +inf there; thread (tx, ty) scores rows 4 ty + i against
    words k0 + 4 tx + j, tiles ascending then j, keeping its minimum with a
    strict <; then the 16 threads of a row merge by shuffle xor 8, 4, 2, 1,
    ties to the lower word.  -> (word index (M,), min s (M,))."""
    R, W, m = tbow.SEARCH_ROWS, tbow.SEARCH_WORDS, tbow.SEARCH_MICRO
    M, D = desc.shape
    K = cents.shape[0]
    Mp, Kp = -(-M // R) * R, -(-K // W) * W
    d = np.zeros((Mp, D), np.float32)
    d[:M] = desc
    c = np.zeros((Kp, D), np.float32)
    c[:K] = cents
    c2 = _seq_sq(c)
    c2[K:] = np.inf
    s = np.float32(-2.0) * _seq_dot(d, c) + c2[None, :]
    n_tx = W // m
    best = np.full((Mp, n_tx), np.inf, np.float32)
    best_k = np.zeros((Mp, n_tx), np.int64)
    for k0 in range(0, Kp, W):
        for j in range(m):
            for tx in range(n_tx):
                k = k0 + m * tx + j
                better = s[:, k] < best[:, tx]
                best[better, tx] = s[better, k]
                best_k[better, tx] = k
    lane = np.arange(n_tx)
    for off in (8, 4, 2, 1):
        ov, ok = best[:, lane ^ off], best_k[:, lane ^ off]
        take = (ov < best) | ((ov == best) & (ok < best_k))
        best, best_k = np.where(take, ov, best), np.where(take, ok, best_k)
    assert (best == best[:, :1]).all() and (best_k == best_k[:, :1]).all()
    return best_k[:M, 0], best[:M, 0]


@pytest.mark.parametrize("K", [1, 63, 64, 65, 250])
@pytest.mark.parametrize("M,D", [(100, 128), (64, 16), (33, 37)])
def test_search_replay_matches_bow_assign_plain(K, M, D):
    """Rows not a multiple of the block, K at and around a tile: the
    replay's index and min + |d|^2 equal `bow_assign_plain` bit for bit."""
    rng = np.random.default_rng(K + M + D)
    desc = rng.standard_normal((M, D)).astype(np.float32)
    cents = rng.standard_normal((K, D)).astype(np.float32)
    idx, best = _replay_search(desc, cents)
    want_i, want_d2 = tbow.bow_assign_plain(torch.from_numpy(desc), torch.from_numpy(cents))
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_array_equal((best + _seq_sq(desc)).astype(np.float32), want_d2.numpy())


@pytest.mark.parametrize("lo,hi", [(63, 64), (3, 200), (0, 249), (64, 128)])
def test_search_replay_ties_across_a_tile_go_low(lo, hi):
    """Word `hi` duplicates word `lo`, across (or at) a word-tile boundary;
    rows sitting on it tie exactly, and the lower word wins, as in the plain
    version; so do all-equal rows against a codebook of equal words."""
    rng = np.random.default_rng(lo * 1000 + hi)
    cents = rng.standard_normal((250, 24)).astype(np.float32)
    cents[hi] = cents[lo]
    desc = (cents[lo][None, :] + np.float32(1e-3) * rng.standard_normal((70, 24))).astype(np.float32)
    idx, _ = _replay_search(desc, cents)
    want, _ = tbow.bow_assign_plain(torch.from_numpy(desc), torch.from_numpy(cents))
    np.testing.assert_array_equal(idx, want.numpy())
    assert (idx == lo).mean() > 0.5
    same = np.ones((65, 24), np.float32)
    flat = np.tile(np.float32(0.5) * np.ones(24, np.float32), (130, 1))
    idx, _ = _replay_search(same, flat)
    assert (idx == 0).all()
    np.testing.assert_array_equal(idx, tbow.bow_assign_plain(torch.from_numpy(same),
                                                             torch.from_numpy(flat))[0].numpy())


def test_search_replay_histograms_with_invalid_rows():
    """The search over an image batch's rows flattened into one matrix (as
    `bow_assign` takes them), each valid row's weight added to its own
    image's row: the histograms equal the plain version's, invalid rows
    (and a whole invalid image) adding nothing."""
    descs, valids, cents = _problem(12, 5, 37, 32, 70, p_valid=0.6)
    valids[2] = 0
    B, N, D = descs.shape
    idx, _ = _replay_search(descs.reshape(B * N, D), cents)
    h = np.zeros((B, cents.shape[0]), np.float32)
    for r in range(B * N):
        if valids.reshape(-1)[r] != 0:
            h[r // N, idx[r]] += valids.reshape(-1)[r]
    want = tbow.quantize_hist_plain(torch.from_numpy(descs), torch.from_numpy(valids),
                                    torch.from_numpy(cents))
    np.testing.assert_array_equal(h, want.numpy())
    assert h[2].sum() == 0


def test_search_block_geometry_matches_the_kernel():
    """The replay's block is the kernel's (csrc/bow.cu kTileN, kTileK,
    kChunk, kThreads) and its shared memory stays within the 48 KB a launch
    takes without opting in."""
    import re
    from pathlib import Path

    src = (Path(tbow.__file__).resolve().parents[1] / "csrc" / "bow.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kTileN"]), int(consts["kTileK"]), int(consts["kChunk"]),
            int(consts["kThreads"]), int(consts["kMicro"])) == (
        tbow.SEARCH_ROWS, tbow.SEARCH_WORDS, tbow.SEARCH_CHUNK, tbow.SEARCH_THREADS,
        tbow.SEARCH_MICRO)
    assert (tbow.SEARCH_ROWS // tbow.SEARCH_MICRO) * (tbow.SEARCH_WORDS // tbow.SEARCH_MICRO) \
        == tbow.SEARCH_THREADS
    ld = tbow.SEARCH_ROWS + 4
    assert 4 * (4 * tbow.SEARCH_CHUNK * ld + tbow.SEARCH_WORDS + tbow.SEARCH_ROWS) <= 48 * 1024


# ---------------------------------------------------------------------------
# bow_quantize_hist's cluster walk (csrc/bow.cu quantize_hist_kernel), in numpy
# ---------------------------------------------------------------------------

def _replay_clusters(descs, valids, cents, normalize):
    """`quantize_hist_kernel` over (B, N, D) rows: one cluster of
    `hist_ranks(K)` ranks an image; the image's rows in tiles of
    `HIST_ROWS` (zero-filled past N); rank r walks word tiles r, r + S, ...
    of `HIST_WORDS` (zero-filled past K, |c|^2 = +inf there), thread (tx,
    ty) keeping its minimum over words k0 + 4 tx + 4 n_tx g + e (g <
    `HIST_MICRO_WORDS` / 4, e < 4, n_tx threads a row), tiles ascending,
    then g and e, with a strict <, the threads of a row merged by
    shuffle xor (half their count down to 1), ties to the lower word; rank 0 merges the ranks' pairs in ascending rank on (value, then
    word), adds each row's weight to its word in ascending n (carried
    across row tiles), sums the total weight in ascending n and divides by
    max(total, 1e-6) with ``normalize``.  -> (B, K) f32."""
    R, W, m = tbow.HIST_ROWS, tbow.HIST_WORDS, tbow.HIST_MICRO_WORDS
    B, N, D = descs.shape
    K = cents.shape[0]
    S = tbow.hist_ranks(K)
    n_tiles = -(-K // W)
    c = np.zeros((n_tiles * W, D), np.float32)
    c[:K] = cents
    c2 = _seq_sq(c)
    c2[K:] = np.inf
    w = valids.astype(np.float32)
    n_tx = W // m
    lane = np.arange(n_tx)
    out = np.zeros((B, K), np.float32)
    for b in range(B):
        h = np.zeros(K, np.float32)
        total = np.float32(0.0)
        for n0 in range(0, N, R):
            nr = min(R, N - n0)
            d = np.zeros((R, D), np.float32)
            d[:nr] = descs[b, n0:n0 + nr]
            s = np.float32(-2.0) * _seq_dot(d, c) + c2[None, :]
            cand_v, cand_k = [], []
            for rank in range(S):
                best = np.full((R, n_tx), np.inf, np.float32)
                best_k = np.zeros((R, n_tx), np.int64)
                for tile in range(rank, n_tiles, S):
                    for j in range(m):  # thread tx's words 4 tx + 4 n_tx g + e, ascending
                        ks = tile * W + 4 * lane + n_tx * (j & ~3) + (j & 3)
                        better = s[:, ks] < best
                        best = np.where(better, s[:, ks], best)
                        best_k = np.where(better, ks[None, :], best_k)
                off = n_tx // 2
                while off:
                    ov, ok = best[:, lane ^ off], best_k[:, lane ^ off]
                    take = (ov < best) | ((ov == best) & (ok < best_k))
                    best, best_k = np.where(take, ov, best), np.where(take, ok, best_k)
                    off //= 2
                cand_v.append(best[:, 0])
                cand_k.append(best_k[:, 0])
            v, k = cand_v[0], cand_k[0]
            for ov, ok in zip(cand_v[1:], cand_k[1:]):
                take = (ov < v) | ((ov == v) & (ok < k))
                v, k = np.where(take, ov, v), np.where(take, ok, k)
            for r in range(nr):
                total = np.float32(total + w[b, n0 + r])
            for r in range(nr):
                h[k[r]] = np.float32(h[k[r]] + w[b, n0 + r])
        out[b] = h / np.maximum(total, np.float32(1e-6)) if normalize else h
    return out


def _weights(valids, kind, seed):
    if kind == "bool":
        return valids
    if kind == "unit_f32":
        return valids.astype(np.float32)
    rng = np.random.default_rng(seed)
    return (rng.random(valids.shape) * valids).astype(np.float32)


CLUSTER_SHAPES = [(3, 32, 128, 250), (2, 45, 128, 7), (1, 100, 16, 700), (4, 5, 16, 130),
                  (2, 65, 24, 64), (1, 40, 16, 1300)]


@pytest.mark.parametrize("kind", ["bool", "unit_f32", "fractional"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("B,N,D,K", CLUSTER_SHAPES)
def test_cluster_replay_is_bit_equal_to_plain(B, N, D, K, normalize, kind):
    """Row tiles of 32 (N = 40, 45, 65, 100 take two to four), one to
    eight ranks (K = 700: six; K = 1300: eight, ranks 0-2 walking two word
    tiles), the rank-0 merge and the ordered sums: the replay equals
    `quantize_hist_plain` bit for bit, for both normalisations and for
    bool, {0, 1} f32 and fractional weights."""
    descs, valids, cents = _problem(B + N + D + K, B, N, D, K)
    valids[0, : N // 2] = False
    w = _weights(valids, kind, seed=K)
    got = _replay_clusters(descs, w, cents, normalize)
    want = tbow.quantize_hist_plain(torch.from_numpy(descs), torch.from_numpy(w),
                                    torch.from_numpy(cents), normalize=normalize).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "fractional":  # the CPU wrapper runs the same plain version
        np.testing.assert_array_equal(
            tbow.bow_quantize_hist(torch.from_numpy(descs), torch.from_numpy(w),
                                   torch.from_numpy(cents), normalize=normalize).numpy(), want)


@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (2, 45, 128, 7), (1, 100, 16, 700),
                                     (4, 5, 16, 130)])
def test_cluster_replay_matches_jax_kernel(B, N, D, K):
    """Against JAX's `bow_quantize_hist` (interpret mode): the counts by the
    near-tie rule, and the normalised rows bit for bit wherever the counts
    agree ({0, 1} weights: the total weight is the row's sum)."""
    descs, valids, cents = _problem(B * N + K + 1, B, N, D, K)
    args = (jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(cents))
    counts = _replay_clusters(descs, valids, cents, False)
    want = np.asarray(jbow.bow_quantize_hist(*args, vc=VC, normalize=False))
    assert assert_hist_near_tie_rule(counts, want, descs, valids, cents) == 0
    same = np.all(counts == want, axis=1)
    got_n = _replay_clusters(descs, valids, cents, True)
    want_n = np.asarray(jbow.bow_quantize_hist(*args, vc=VC, normalize=True))
    np.testing.assert_array_equal(got_n[same], want_n[same])


@pytest.mark.parametrize("kind", ["bool", "unit_f32"])
def test_unit_weight_normalisations_are_bit_equal(kind):
    """With {0, 1} weights every sum is an exact integer: dividing by the
    total weight (the kernel's) equals dividing by the row sum of the counts
    (`normalize_hist`, JAX's), bit for bit; an all-invalid image stays 0."""
    descs, valids, cents = _problem(31, 6, 40, 32, 90)
    valids[2] = False
    w = torch.from_numpy(_weights(valids, kind, seed=0))
    d, c = torch.from_numpy(descs), torch.from_numpy(cents)
    by_total = tbow.quantize_hist_plain(d, w, c, normalize=True)
    by_rows = tbow.normalize_hist(tbow.quantize_hist_plain(d, w, c))
    assert torch.equal(by_total, by_rows)
    assert float(by_total[2].abs().sum()) == 0.0


@pytest.mark.parametrize("K,lo,hi", [(250, 10, 200), (1300, 130, 1030)])
def test_cluster_replay_ties_across_ranks_go_low(K, lo, hi):
    """Word `hi` duplicates word `lo` in another rank's tile (at K = 1300,
    word 1030 is rank 0's second tile and word 130 rank 1's first, so a
    merge that kept the lower rank on a tie would take 1030): rows sitting
    on them tie exactly, and rank 0's merge keeps the lower word, as the
    plain argmin does; so does a codebook of equal words."""
    rng = np.random.default_rng(K + lo)
    cents = rng.standard_normal((K, 24)).astype(np.float32)
    cents[hi] = cents[lo]
    descs = (cents[lo] + np.float32(1e-3) * rng.standard_normal((2, 40, 24))).astype(np.float32)
    valids = np.ones((2, 40), bool)
    got = _replay_clusters(descs, valids, cents, False)
    want = tbow.quantize_hist_plain(torch.from_numpy(descs), torch.from_numpy(valids),
                                    torch.from_numpy(cents)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, lo].sum() > 40 and got[:, hi].sum() == 0
    flat = np.full((700, 24), 0.5, np.float32)
    got = _replay_clusters(np.ones((1, 33, 24), np.float32), np.ones((1, 33), bool), flat, False)
    assert got[0, 0] == 33 and got.sum() == 33


def test_hist_cluster_geometry_matches_the_kernel():
    """The replay's CTA is the kernel's (csrc/bow.cu kHist*): its
    micro-tiles cover the tile's rows x words, a row group's threads are
    lanes of one warp; `HIST_MIN_BLOCKS` CTAs an SM (its __launch_bounds__)
    fit the SM's 228 KB of shared memory with the 1 KB each CTA reserves;
    the cluster takes a rank per word tile, at most eight."""
    import re
    from pathlib import Path

    src = (Path(tbow.__file__).resolve().parents[1] / "csrc" / "bow.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    names = ("Rows", "Words", "Threads", "Chunk", "MicroRows", "MicroWords", "MinBlocks",
             "MaxRanks")
    assert tuple(int(consts[f"kHist{n}"]) for n in names) == (
        tbow.HIST_ROWS, tbow.HIST_WORDS, tbow.HIST_THREADS, tbow.HIST_CHUNK,
        tbow.HIST_MICRO_ROWS, tbow.HIST_MICRO_WORDS, tbow.HIST_MIN_BLOCKS, tbow.HIST_MAX_RANKS)
    n_tx = tbow.HIST_WORDS // tbow.HIST_MICRO_WORDS
    assert (tbow.HIST_ROWS // tbow.HIST_MICRO_ROWS) * n_tx == tbow.HIST_THREADS
    assert n_tx <= 32 and 32 % n_tx == 0
    assert "__launch_bounds__(kHistThreads, kHistMinBlocks)" in src
    assert tbow.HIST_MIN_BLOCKS * (tbow.hist_smem_bytes() + 1024) <= 228 * 1024
    # shared memory would hold eight CTAs an SM; the registers the 4 x 8
    # micro-tiles take (108 on the H100) hold `HIST_MIN_BLOCKS`
    assert 8 * (tbow.hist_smem_bytes() + 1024) <= 228 * 1024
    assert tbow.hist_smem_bytes() <= 48 * 1024  # no opt-in attribute needed
    assert [tbow.hist_ranks(K) for K in (1, 128, 129, 250, 512, 513, 700, 1300)] == \
        [1, 1, 2, 2, 4, 5, 6, 8]
    # the predict request's clusters fit the card at once (one wave)
    assert 256 * tbow.hist_ranks(250) <= tbow.HIST_MIN_BLOCKS * 132


# -- `cv.bow.histograms`: every form JAX's takes -------------------------------------------

HIST_FORMS = {
    # name: the call, the same API in both packages' `cv.bow`, on (descs, valids, cents)
    "batched": lambda m, d, v, c: m.histograms(d, v, c),
    "unbatched": lambda m, d, v, c: m.histograms(d[0], v[0], c),
    "fused": lambda m, d, v, c: m.histograms(d, v, c, fused=True),
    "fused unbatched": lambda m, d, v, c: m.histograms(d[1], v[1], c, fused=True),
    "use_kernel=False": lambda m, d, v, c: m.histograms(d, v, c, use_kernel=False),
    "histogram": lambda m, d, v, c: m.histogram(d[2], v[2], c),
    "histogram use_kernel=False": lambda m, d, v, c: m.histogram(d[2], v[2], c, use_kernel=False),
    "batch_histograms": lambda m, d, v, c: m.batch_histograms(d, v, c),
}


@pytest.mark.parametrize("form", HIST_FORMS)
@pytest.mark.parametrize("B,N,D,K", [(3, 32, 128, 250), (4, 5, 16, 7)])
def test_histogram_forms_match_jax(form, B, N, D, K):
    from repro.cv import bow as jbow_cv

    from repro_torch.cv import bow as tbow_cv

    descs, valids, cents = _problem(7 * B + K, B, N, D, K)
    call = HIST_FORMS[form]
    want = np.asarray(call(jbow_cv, jnp.asarray(descs), jnp.asarray(valids), jnp.asarray(cents)))
    got = call(tbow_cv, torch.from_numpy(descs), torch.from_numpy(valids),
                torch.from_numpy(cents)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # back to counts, then the near-tie rule (exact on this data)
    rows = {"unbatched": [0], "fused unbatched": [1], "histogram": [2],
            "histogram use_kernel=False": [2]}.get(form, list(range(B)))
    d, v = descs[rows], valids[rows]
    counts = v.sum(axis=1, keepdims=True).clip(min=1)
    n_ties = assert_hist_near_tie_rule(got.reshape(len(rows), K) * counts,
                                       want.reshape(len(rows), K) * counts, d, v, cents)
    assert n_ties == 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_histograms_route_by_option(monkeypatch):
    """``use_kernel=False`` never reaches the `bow_assign` wrapper, and
    ``fused=True`` only `bow_quantize_hist`."""
    from repro_torch.cv import bow as tbow_cv

    descs, valids, cents = (torch.from_numpy(a) for a in _problem(3, 2, 6, 16, 5))
    calls = []
    for name in ("bow_assign", "bow_assign_plain", "bow_quantize_hist"):
        real = getattr(tbow, name)
        monkeypatch.setattr(tbow, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                              _r(*a, **k))[1])
    for kw, want in (({}, ["bow_assign", "bow_assign_plain"]),
                     ({"use_kernel": False}, ["bow_assign_plain"]),
                     ({"fused": True}, ["bow_quantize_hist"])):
        calls.clear()
        tbow_cv.histograms(descs, valids, cents, **kw)
        assert calls == want, kw
