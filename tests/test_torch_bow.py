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
