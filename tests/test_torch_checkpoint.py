"""Checkpoints and the token stream of the port, on the CPU: the cases of
`tests/test_checkpoint.py` on the port's `train.checkpoint` (a round trip,
keep-last-k, the fallback past a corrupt step, the async saver), the JAX
package's on-disk layout (a port checkpoint read back by JAX's `restore`),
a training state's named tensors through save and restore, and
`data.synthetic.TokenStream.batch_at` equal to JAX's value for value."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.data.synthetic import TokenStream as JaxTokenStream
from repro.train import checkpoint as jck

from repro_torch.configs import reduced_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.train import checkpoint as ck
from repro_torch.train import step as tstep


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b.c": torch.arange(10, dtype=torch.int32),
            "b.d": torch.tensor(3.5),
            "w": torch.randn((4, 6), generator=g).to(torch.bfloat16)}


def _zeros_like(t):
    return {k: torch.zeros_like(v) for k, v in t.items()}


def test_save_restore_roundtrip(tmp_path):
    t = _tensors()
    ck.save(str(tmp_path), 10, t)
    out, step = ck.restore(str(tmp_path), _zeros_like(t))
    assert step == 10 and list(out) == list(t)
    for k in t:
        assert out[k].dtype == t[k].dtype and torch.equal(out[k], t[k]), k


def test_restore_casts_to_the_target(tmp_path):
    t = _tensors()
    ck.save(str(tmp_path), 1, t)
    target = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in t.items()}
    out, _ = ck.restore(str(tmp_path), target)
    for k in t:
        assert out[k].dtype == torch.float64
        assert torch.equal(out[k], t[k].double()), k


def test_keep_last_k_and_latest(tmp_path):
    t = _tensors()
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, t, keep=2)
    assert ck.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ck.latest_step(str(tmp_path / "missing")) is None


def test_corruption_fallback(tmp_path):
    t = _tensors()
    ck.save(str(tmp_path), 1, t)
    ck.save(str(tmp_path), 2, t)
    (tmp_path / "step_00000002" / "leaf_00000.npy").write_bytes(b"garbage")
    out, step = ck.restore(str(tmp_path), _zeros_like(t))
    assert step == 1 and torch.equal(out["a"], t["a"])
    # a leaf whose bytes changed (same length) fails its sha256 too
    ck.save(str(tmp_path), 3, t)
    leaf = tmp_path / "step_00000003" / "leaf_00001.npy"
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 1
    leaf.write_bytes(bytes(raw))
    assert ck.restore(str(tmp_path), _zeros_like(t))[1] == 1


def test_names_must_match_and_nothing_usable_raises(tmp_path):
    t = _tensors()
    ck.save(str(tmp_path), 1, t)
    renamed = {("z" + k): v for k, v in t.items()}
    with pytest.raises(FileNotFoundError, match="no usable checkpoint"):
        ck.restore(str(tmp_path), _zeros_like(renamed))


def test_async_saver_copies_before_the_thread(tmp_path):
    t = _tensors()
    saved = {k: v.clone() for k, v in t.items()}
    s = ck.AsyncSaver()
    s.save(str(tmp_path), 5, t)
    t["a"].add_(1.0)  # a step after the save changes the live tensors
    s.wait()
    assert ck.latest_step(str(tmp_path)) == 5
    out, _ = ck.restore(str(tmp_path), _zeros_like(saved))
    assert torch.equal(out["a"], saved["a"])


def test_layout_is_the_jax_packages(tmp_path):
    """The manifest holds the names, shapes, logical dtypes and sha256s; a
    bf16 leaf is its raw u16; no .tmp directory is left; JAX's `restore`
    reads the port's checkpoint back."""
    t = _tensors()
    path = ck.save(str(tmp_path), 7, t)
    assert sorted(os.listdir(tmp_path)) == ["step_00000007"]
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert manifest["paths"] == list(t) and manifest["n_leaves"] == len(t)
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["float32", "int32", "float32",
                                                              "bfloat16"]
    assert np.load(os.path.join(path, "leaf_00003.npy")).dtype == np.uint16
    target = [jnp.zeros(v.shape, jnp.bfloat16 if v.dtype == torch.bfloat16 else
                        jnp.dtype(str(v.dtype).removeprefix("torch."))) for v in t.values()]
    out, step = jck.restore(str(tmp_path), target)
    assert step == 7
    for got, want in zip(out, t.values()):
        np.testing.assert_array_equal(np.asarray(jnp.asarray(got).astype(jnp.float32)),
                                      want.float().numpy())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_state_round_trip(tmp_path, optimizer):
    cfg = reduced_config("deepseek-v3-671b")
    state = tstep.init_state(cfg, optimizer=optimizer, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    ts = tstep.make_train_step(cfg, optimizer=optimizer, peak_lr=1e-3, warmup=1)
    for i in range(2):
        state, _ = ts(state, stream.batch_at(i))
    names = list(tstep.state_tensors(state))
    # JAX's checkpoint order and key paths: the flattened {"opt", "params", "step"}
    assert names[0] == "['opt']['count']" and names[-1] == "['step']"
    assert names == tstep.state_names(state)
    assert "['params']['embed']" in names and "['params']['groups'][1]['moe']['w_gate']" in names
    ck.save(str(tmp_path), 2, tstep.state_tensors(state))
    fresh = tstep.init_state(cfg, optimizer=optimizer, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    tensors, step = ck.restore(str(tmp_path), tstep.state_tensors(fresh))
    tstep.load_state_tensors(fresh, tensors)
    assert step == 2 and fresh["step"] == 2 and fresh["opt"]["count"] == 2
    want = tstep.state_tensors(state)
    for k, v in tstep.state_tensors(fresh).items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="names"):
        tstep.load_state_tensors(fresh, dict(list(tensors.items())[1:]))


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (0, 2), (1, 2)])
def test_token_stream_matches_jax(shard, n_shards):
    kw = dict(vocab_size=1000, seq_len=33, global_batch=8, seed=3, n_shards=n_shards,
              shard=shard)
    port, ref = TokenStream(**kw), JaxTokenStream(**kw)
    for step in (0, 1, 7, 123):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == torch.int64 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # labels are the next tokens
    b = port.batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="shards"):
        TokenStream(vocab_size=10, seq_len=4, global_batch=3, n_shards=2)


def test_jax_tree_unchanged_by_port_import():
    # the port's checkpoint module imports no JAX: the JAX one still does
    assert "jax" in jck.__dict__ and "jax" not in ck.__dict__
    assert jax.__name__ == "jax"
