"""Synthetic datasets: a copy of ``repro/data/synthetic.py`` (numpy only,
so both packages draw the same data from the same seed; no download).

``SyntheticImageDataset``: a class-conditional image task.  Each class owns
a random low-frequency prototype; a sample is the prototype cyclically
shifted plus Gaussian noise, and ``augment`` applies the paper's
augmentation (4-px zero pad, random crop, random horizontal flip) at batch
time.  More classes crowd the prototypes, so 10 classes stand in for
CIFAR-10 and 100 for CIFAR-100.  Images are NHWC float32.

``SyntheticLMDataset``: token streams where t_{i+1} = (a*t_i + b) mod V on
``structure`` of the steps and uniform noise otherwise.

``SyntheticSeqClsDataset``: class-conditional token sequences (each class
owns a few signature tokens), labels in ``[0, num_classes)``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticImageDataset:
    num_classes: int = 10
    image_size: int = 32
    train_size: int = 50_000
    test_size: int = 10_000
    noise: float = 0.9              # sample noise std (difficulty knob)
    proto_scale: float = 1.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        # low-frequency prototypes: upsampled 8x8 random fields
        low = rng.normal(size=(self.num_classes, 8, 8, 3)).astype(np.float32)
        reps = s // 8
        self.prototypes = (np.repeat(np.repeat(low, reps, 1), reps, 2)
                           * self.proto_scale)
        self._train = self._make_split(rng, self.train_size)
        self._test = self._make_split(rng, self.test_size)

    def _make_split(self, rng, n) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, self.num_classes, size=n).astype(np.int32)
        imgs = self.prototypes[labels].copy()
        # per-sample cyclic shift (makes the task non-template-matching)
        sh = rng.integers(0, 4, size=(n, 2))
        for axis in (0, 1):
            for k in range(1, 4):
                idx = sh[:, axis] == k
                imgs[idx] = np.roll(imgs[idx], k, axis=axis + 1)
        imgs += rng.normal(scale=self.noise, size=imgs.shape).astype(np.float32)
        return imgs, labels

    @property
    def train(self):
        return self._train

    @property
    def test(self):
        return self._test

    @staticmethod
    def augment(rng: np.random.Generator, imgs: np.ndarray) -> np.ndarray:
        """Paper augmentation: zero-pad 4px, random crop, random hflip."""
        n, h, w, c = imgs.shape
        padded = np.pad(imgs, ((0, 0), (4, 4), (4, 4), (0, 0)))
        out = np.empty_like(imgs)
        ys = rng.integers(0, 9, size=n)
        xs = rng.integers(0, 9, size=n)
        flips = rng.random(n) < 0.5
        for i in range(n):
            crop = padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w]
            out[i] = crop[:, ::-1] if flips[i] else crop
        return out


@dataclass
class SyntheticLMDataset:
    vocab_size: int = 32_000
    seq_len: int = 256
    seed: int = 0
    structure: float = 0.9          # fraction of affine next-token steps

    def batches(self, batch_size: int, num_batches: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        V, T = self.vocab_size, self.seq_len
        for _ in range(num_batches):
            a = rng.integers(1, 64, size=(batch_size, 1))
            b = rng.integers(0, V, size=(batch_size, 1))
            toks = np.empty((batch_size, T + 1), np.int64)
            toks[:, 0] = rng.integers(0, V, size=batch_size)
            for t in range(T):
                nxt = (a[:, 0] * toks[:, t] + b[:, 0]) % V
                noise = rng.integers(0, V, size=batch_size)
                use_noise = rng.random(batch_size) > self.structure
                toks[:, t + 1] = np.where(use_noise, noise, nxt)
            yield toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@dataclass
class SyntheticSeqClsDataset:
    """Class-conditional token sequences for sequence classification.

    Class ``c`` owns ``signature`` random vocabulary tokens; each position is
    a signature draw with probability ``p_signal`` and uniform noise
    otherwise.  Labels are class ids in ``[0, num_classes)`` — a strict
    subset of the vocabulary, so V-way logits (an LM/exit head) score them
    directly.  Difficulty is controlled by ``p_signal`` and ``num_classes``.
    """

    vocab_size: int
    seq_len: int = 16
    num_classes: int = 8
    train_size: int = 512
    test_size: int = 256
    signature: int = 8              # signature tokens per class
    p_signal: float = 0.5           # per-position probability of a signature
    seed: int = 0

    def __post_init__(self):
        assert self.num_classes <= self.vocab_size
        rng = np.random.default_rng(self.seed)
        self.signatures = rng.integers(
            0, self.vocab_size, size=(self.num_classes, self.signature))
        self._train = self._make_split(rng, self.train_size)
        self._test = self._make_split(rng, self.test_size)

    def _make_split(self, rng, n) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, self.num_classes, size=n).astype(np.int32)
        pick = rng.integers(0, self.signature, size=(n, self.seq_len))
        sig = self.signatures[labels[:, None], pick]
        noise = rng.integers(0, self.vocab_size, size=(n, self.seq_len))
        use_sig = rng.random((n, self.seq_len)) < self.p_signal
        toks = np.where(use_sig, sig, noise).astype(np.int32)
        return toks, labels

    @property
    def train(self):
        return self._train

    @property
    def test(self):
        return self._test

    def dirichlet_shards(self, num_clients: int, alpha: float = 0.5,
                         seed: int | None = None, min_size: int = 0):
        """Non-IID client shards of the train split, label-skewed by a
        ``data.pipeline.DirichletPartitioner`` — the client-population
        subsystem's default data source.  ``seed``
        defaults to the dataset's own seed so dataset identity pins the
        partition."""
        from repro_torch.data.pipeline import DirichletPartitioner
        part = DirichletPartitioner(
            num_clients, alpha=alpha,
            seed=self.seed if seed is None else seed, min_size=min_size)
        return part.split(*self._train)
