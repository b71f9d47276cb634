"""Deterministic synthetic data (copies of `repro.data.synthetic`'s
`TokenStream` and `ImageStream` that return CPU torch tensors).

`TokenStream.batch_at(step)` is a pure function of (seed, shard, step),
so restarts resume exactly: Zipfian unigrams with a Markov bigram rule,
so that the cross-entropy has a learnable signal; JAX's values, as int64.

`ImageStream.batch` seeds its generator with ``hash(split)``, as the JAX
package's does.  Python salts the hash of a string per process, so a
string split gives the same images within one process only; an integer
split (whose hash is itself) gives the same images in every process.
"""

from __future__ import annotations

import numpy as np
import torch


class TokenStream:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0):
        if global_batch % n_shards:
            raise ValueError(f"global batch {global_batch} over {n_shards} shards")
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch // n_shards
        self.seed = seed
        self.shard = shard
        # fixed Markov mixing parameters (the vocab-sized state stays implicit)
        self._a = 1664525
        self._c = 1013904223

    def batch_at(self, step: int) -> dict:
        """step -> {"tokens": (B, S), "labels": (B, S)}, int64 on the CPU."""
        rng = np.random.default_rng((self.seed, self.shard, step))
        zipf = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        base = (zipf - 1) % self.vocab
        # bigram structure: with p = 0.5 the next token is a fixed function
        # of the previous one (the learnable signal)
        follow = (base[:, :-1] * self._a + self._c) % self.vocab
        coin = rng.random((self.batch, self.seq)) < 0.5
        seq = np.where(coin, follow, base[:, 1:])
        tokens = np.concatenate([base[:, :1], seq[:, :-1]], axis=1)
        return {"tokens": torch.from_numpy(tokens.astype(np.int64)),
                "labels": torch.from_numpy(seq.astype(np.int64))}


class ImageStream:
    """Synthetic CIFAR-like classification set: 10 generative classes with
    distinct spatial structure (bars, blobs, checker, gradient x frequency),
    32x32x3 u8, the compute character of the paper's Cifar-10 testbed."""

    def __init__(self, *, n_classes: int = 10, res: int = 32, seed: int = 0):
        self.n_classes = n_classes
        self.res = res
        self.seed = seed

    def batch(self, n: int, *, split: str | int = "train"):
        """-> (images (n, res, res, 3) uint8, labels (n,) int32), on the CPU."""
        rng = np.random.default_rng((self.seed, hash(split) % 2**31))
        y = rng.integers(0, self.n_classes, n)
        xs = np.zeros((n, self.res, self.res, 3), np.uint8)
        i_idx, j_idx = np.meshgrid(np.arange(self.res), np.arange(self.res), indexing="ij")
        for i in range(n):
            c = y[i]
            phase = rng.random() * 2 * np.pi
            freq = 1 + (c % 5)
            angle = (c // 5) * np.pi / 4 + rng.normal(0, 0.1)
            wave = np.sin(
                freq * 2 * np.pi / self.res * (np.cos(angle) * i_idx + np.sin(angle) * j_idx)
                + phase
            )
            blob_x, blob_y = rng.integers(8, 24, 2)
            blob = np.exp(
                -(((i_idx - blob_x) ** 2 + (j_idx - blob_y) ** 2) / (2 + 3 * (c % 3)) ** 2)
            )
            img = 0.6 * wave + 0.8 * blob * ((c % 2) * 2 - 1)
            img = img + rng.normal(0, 0.15, img.shape)
            for ch in range(3):
                scale = 0.5 + 0.5 * np.sin(c + ch)
                xs[i, :, :, ch] = np.clip((img * scale * 0.5 + 0.5) * 255, 0, 255)
        return torch.from_numpy(xs), torch.from_numpy(y.astype(np.int32))

    def image(self, resolution: tuple[int, int], *, channels: int = 1, seed: int = 0):
        """A single large test image (for the filtering/erosion benchmarks)."""
        rng = np.random.default_rng((self.seed, seed, resolution[0]))
        h, w = resolution
        shape = (h, w) if channels == 1 else (h, w, channels)
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
