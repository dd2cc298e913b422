"""Batches of a map-style dataset for the training loop.

Counterpart of the host-loader path of ``sr3_tpu/data/loader.py``
(``DataLoader``, ``create_dataloader``): a seeded shuffle per epoch,
``drop_last`` for training, and numpy collation of the dataset's NHWC items.
The JAX package's loader imports jax to shard across processes, so the port
keeps this small one; the datasets themselves (``sr3_tpu.data.lrhr``, which
needs Pillow) are built by the entry points (``sr.py``).
"""

from __future__ import annotations

import numpy as np


def collate(samples):
    """Stack a list of item dicts: arrays along a new batch axis, other
    values into a numpy array."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                  else np.asarray(vals))
    return out


class DataLoader:
    """Iterable over the batches of one pass of ``dataset`` per iteration."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            batch = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in batch])


def create_dataloader(dataset, dataset_opt, phase):
    """The train loader: the config's batch size and shuffle, drop_last."""
    if phase != "train":
        raise NotImplementedError(f"the port batches only the train phase, "
                                  f"not {phase!r}")
    return DataLoader(dataset, batch_size=dataset_opt["batch_size"],
                      shuffle=bool(dataset_opt["use_shuffle"]),
                      drop_last=True)
