"""`flash_attention`'s log-sum-exp output and the split-K merges of decode
(`models.attention.merge_lse`, `dense_attention(merge=)`), on the CPU.

The plain version's log-sum-exp is held to `torch.logsumexp` of the
scaled f32 scores each query row sees (causal, not, at a query offset,
over KV head groups) within 1e-5, its outputs bit-equal with and without
it.  The merges run over slices of the keys on one process: a thread a
slice, each thread one "rank" whose max / sum meet the others' at a
barrier (`ThreadMerge`, the rank-order sum a group's all-reduce takes);
the merged output against the whole call within `AGREE` (f32), with a
slice whose keys are all masked weighing exactly 0.
"""

import functools
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as kattn
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm as tlm

LSE_TOL = 1e-5
WAIT_S = 60  # a rank's wait at a merge, and for the threads to finish


class ThreadMerge:
    """`sharding.comm.Over` for `n` threads on one process: rank i's
    ``max`` / ``sum`` return the elementwise maximum / rank-order sum of
    every rank's tensor."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=WAIT_S)
        self.slots = [None] * n

    def rank(self, i: int):
        merge = self

        class Rank:
            def max(self, x):
                return merge._reduce(i, x, torch.maximum)

            def sum(self, x):
                return merge._reduce(i, x, torch.add)

        return Rank()

    def _reduce(self, i, x, op):
        self.slots[i] = x
        self.barrier.wait()
        out = functools.reduce(op, self.slots)
        self.barrier.wait()
        return out


def run_ranks(n: int, fn) -> list:
    """fn(rank, merge) on `n` threads -> their results in rank order."""
    merge = ThreadMerge(n)
    out = [None] * n
    errors = []

    def one(i):
        try:
            out[i] = fn(i, merge.rank(i))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            merge.barrier.abort()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errors:
        raise errors[0]
    return out


def _qkv(B, S, T, H, G, hd, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k = torch.randn(B, T, G, hd, generator=g).to(dtype)
    v = torch.randn(B, T, G, hd, generator=g).to(dtype)
    return q, k, v


def _lse_ref(q, k, causal: bool, q_off: int) -> torch.Tensor:
    """torch.logsumexp of the scaled f32 scores each row sees -> (B, H, S)."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(H // G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), kr) / math.sqrt(hd)
    if causal:
        qi = torch.arange(q_off, q_off + S)[:, None]
        s = torch.where(torch.arange(T)[None, :] <= qi, s, -math.inf)
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("causal,q_off", [(True, 0), (False, 0), (True, 37), (True, 130)])
@pytest.mark.parametrize("H,G", [(4, 4), (4, 2), (6, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lse_is_the_logsumexp_of_the_scaled_scores(causal, q_off, H, G, dtype):
    q, k, v = _qkv(2, 9, 150, H, G, 16, dtype)
    out, lse = kattn.flash_attention_plain(q, k, v, causal=causal, q_off=q_off, lse=True)
    assert lse.shape == (2, H, 9) and lse.dtype == torch.float32
    want = _lse_ref(q, k, causal, q_off)
    assert float((lse - want).abs().max()) < LSE_TOL
    # the outputs are the same with and without it, bit for bit
    assert torch.equal(out, kattn.flash_attention_plain(q, k, v, causal=causal, q_off=q_off))
    # the wrapper's CPU route is the plain version
    out_w, lse_w = kattn.flash_attention(q, k, v, causal=causal, q_off=q_off, lse=True)
    assert torch.equal(out_w, out) and torch.equal(lse_w, lse)


def test_lse_of_a_row_without_keys_is_minus_1e30():
    q, k, v = _qkv(1, 3, 0, 2, 2, 8)
    out, lse = kattn.flash_attention_plain(q, k, v, causal=False, lse=True)
    assert torch.equal(lse, torch.full((1, 2, 3), kattn.NEG))
    assert torch.equal(out, torch.zeros_like(out))


def test_lse_has_no_gradient_and_the_meta_route_shapes_it():
    q, k, v = _qkv(1, 4, 8, 2, 2, 8)
    with pytest.raises(ValueError, match="no gradient"):
        kattn.flash_attention(q.requires_grad_(), k, v, lse=True)
    qm, km, vm = (t.detach().to("meta") for t in (q, k, v))
    out, lse = kattn.flash_attention(qm, km, vm, lse=True)
    assert out.shape == qm.shape and lse.shape == (1, 2, 4) and lse.dtype == torch.float32
    f0, b0 = kattn.flash_work(q, k, v, True)
    f1, b1 = kattn.flash_work(q, k, v, True, lse=True)
    assert f1 == f0 and b1 - b0 == 4 * 1 * 2 * 4


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("S,H,G,hd", [(1, 16, 16, 8), (1, 8, 2, 16), (5, 4, 4, 64)])
def test_lse_merge_of_context_slices_is_the_whole_call(n, S, H, G, hd):
    """Cross-attention decode over n slices of 64 context rows: each slice's
    normalised output merged by its log-sum-exp."""
    q, k, v = _qkv(3, S, 64, H, G, hd, seed=n)
    whole = kattn.flash_attention(q, k, v, causal=False)
    ks, vs = k.chunk(n, dim=1), v.chunk(n, dim=1)

    def rank(i, merge):
        out, lse = kattn.flash_attention(q, ks[i].contiguous(), vs[i].contiguous(), causal=False,
                                         lse=True)
        return attn_mod.merge_lse(out, lse, merge)

    rtol, atol = kattn.AGREE[torch.float32]
    for got in run_ranks(n, rank):
        torch.testing.assert_close(got, whole, rtol=rtol, atol=atol)


def test_lse_merge_gives_a_slice_without_keys_no_weight():
    q, k, v = _qkv(2, 1, 32, 4, 4, 8, seed=3)
    whole = kattn.flash_attention(q, k, v, causal=False)
    empty = (k[:, :0], v[:, :0])

    def rank(i, merge):
        kk, vv = (k, v) if i == 0 else empty
        out, lse = kattn.flash_attention(q, kk.contiguous(), vv.contiguous(), causal=False,
                                         lse=True)
        return attn_mod.merge_lse(out, lse, merge)

    for got in run_ranks(2, rank):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, whole, rtol=0, atol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pos,T,window,soft_cap", [
    (5, 32, None, None),      # slots 6 .. 31 not yet written: ranks past the first empty
    (30, 32, None, 30.0),     # soft cap
    (47, 32, 24, None),       # a wrapped ring under a window
])
def test_split_k_dense_attention_over_simulated_slices(n, pos, T, window, soft_cap):
    """`dense_attention(merge=)` over each rank's block of T / n ring slots
    (`rules.cache_specs`' contiguous split) against the whole grouped call:
    decode's query at position `pos` over a ring of T slots."""
    q, k, v = _qkv(2, 1, T, 8, 2, 16, seed=pos)
    kv_pos, kv_valid = tlm.ring_positions(pos, T)
    q_pos = torch.full((2, 1), pos)
    kw = dict(causal=True, q_pos=q_pos, window=window, soft_cap=soft_cap, grouped=True)
    whole = attn_mod.dense_attention(q, k, v, kv_pos=kv_pos, kv_valid=kv_valid, **kw)
    w = T // n

    def rank(i, merge):
        sl = slice(i * w, (i + 1) * w)
        return attn_mod.dense_attention(q, k[:, sl], v[:, sl], kv_pos=kv_pos[sl],
                                        kv_valid=kv_valid[sl], merge=merge, **kw)

    for got in run_ranks(n, rank):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


def test_softmax_over_gives_an_all_masked_slice_exact_zeros():
    s = torch.tensor(np.array([[1.0, 2.0, -1e30, -1e30]], dtype=np.float32))

    def rank(i, merge):
        return attn_mod.softmax_over(s[:, 2 * i:2 * i + 2], merge)

    a, b = run_ranks(2, rank)
    assert torch.equal(b, torch.zeros_like(b))
    torch.testing.assert_close(torch.cat([a, b], dim=1), torch.softmax(s, dim=-1), rtol=0,
                               atol=1e-7)
