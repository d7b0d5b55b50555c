"""Data for the forecaster family: the synthetic moving-blob sequences, the
seeded 70/15/15 split, numpy batching, and a prefetch to the device.

Copies of the JAX package's ``data/synthetic.py``
(``SyntheticSequenceDataset``, pure numpy: the same seed gives the same
items bit for bit), ``data/splits.py`` (``Subset``,
``split_dataset_random``) and the single-process half of
``data/pipeline.py`` (``batch_iterator``, ``eval_batches`` with
wrap-padding). ``prefetch_to_device`` takes the place of the JAX
``prefetch_to_device``: it copies each batch from pinned host memory with
``non_blocking`` a batch or two ahead of the step that reads it.

Not ported: the Fenhe and downscaling datasets (the Generator, ROADMAP A8),
the on-disk frames source and grain (ROADMAP A6), the multi-host slicing
(ROADMAP A9).
"""
from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch


class SyntheticSequenceDataset:
    """Moving-blob sequences: item = (input_frames [T_in,1,H,W],
    target_frames [T_out,1,H,W]) float32 in [0, 1]."""

    num_blobs = 3

    def __init__(self, num_sequences: int = 256, input_frames: int = 5,
                 output_frames: int = 10, image_size: int = 64,
                 seed: int = 0):
        self.num_sequences = num_sequences
        self.t_in = input_frames
        self.t_out = output_frames
        self.size = image_size
        self.seed = seed
        yy, xx = np.mgrid[0:image_size, 0:image_size]
        self._yy = yy.astype(np.float32)
        self._xx = xx.astype(np.float32)

    def __len__(self) -> int:
        return self.num_sequences

    def _render(self, pos: np.ndarray, radius: np.ndarray) -> np.ndarray:
        frame = np.zeros((self.size, self.size), np.float32)
        for (py, px), r in zip(pos, radius):
            d2 = (self._yy - py) ** 2 + (self._xx - px) ** 2
            frame += np.exp(-d2 / (2 * r * r)).astype(np.float32)
        return np.clip(frame, 0.0, 1.0)

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        total = self.t_in + self.t_out
        margin = max(2.0, self.size / 8.0)
        speed = max(0.5, self.size / 64.0)
        pos = rng.uniform(margin, self.size - margin,
                          (self.num_blobs, 2)).astype(np.float32)
        vel = rng.uniform(-3 * speed, 3 * speed,
                          (self.num_blobs, 2)).astype(np.float32)
        radius = rng.uniform(self.size / 20.0 + 1.0, self.size / 10.0 + 1.5,
                             self.num_blobs).astype(np.float32)
        frames = np.empty((total, 1, self.size, self.size), np.float32)
        lo, hi = margin / 2.0, self.size - margin / 2.0
        for t in range(total):
            frames[t, 0] = self._render(pos, radius)
            pos = pos + vel
            for d in range(2):          # bounce off the edges
                over = (pos[:, d] < lo) | (pos[:, d] > hi)
                vel[over, d] *= -1
            pos = np.clip(pos, lo, hi)
        return frames[:self.t_in], frames[self.t_in:]


class Subset:
    """Index view over a map-style dataset."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def split_dataset_random(dataset, seed: int = 42):
    """Seeded permutation split into (train, val, test) Subsets, 70/15/15."""
    perm = np.random.RandomState(seed).permutation(len(dataset))
    n_train = int(len(dataset) * 0.7)
    n_val = int(len(dataset) * 0.15)
    print(f"Random split: train {n_train} | val {n_val} | "
          f"test {len(dataset) - n_train - n_val}")
    return (Subset(dataset, perm[:n_train].tolist()),
            Subset(dataset, perm[n_train:n_train + n_val].tolist()),
            Subset(dataset, perm[n_train + n_val:].tolist()))


def _stack(items):
    """A list of example tuples -> a tuple of batched arrays."""
    return tuple(np.stack([it[i] for it in items]) for i in range(len(items[0])))


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   seed: int = 0, epoch: int = 0) -> Iterator:
    """One epoch of full numpy batches (the last partial batch is dropped);
    the order is shuffled by seed + epoch."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    for start in range(0, n - n % batch_size, batch_size):
        yield _stack([dataset[int(i)] for i in order[start:start + batch_size]])


def eval_batches(dataset, batch_size: int) -> Iterator:
    """Full-coverage eval batching: yields (batch, n_valid). The last partial
    batch is wrap-padded to the full batch size; eval steps give the rows
    with index >= n_valid weight zero."""
    n = len(dataset)
    for start in range(0, n, batch_size):
        n_valid = min(batch_size, n - start)
        idx = [(start + j) % n for j in range(batch_size)]
        yield _stack([dataset[i] for i in idx]), n_valid


def to_device(batch, device: torch.device):
    """A tuple of numpy arrays -> tensors on ``device``; to a GPU from
    pinned memory without waiting for the copy."""
    out = []
    for a in batch:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


PREFETCH = 2   # batches copied ahead of the one being consumed


def prefetch_to_device(iterator: Iterable, device: torch.device) -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, ``PREFETCH`` of them
    copied ahead of the one being consumed."""
    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, PREFETCH):
        queue.append(to_device(batch, device))
    while queue:
        out = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(to_device(nxt, device))
        yield out
