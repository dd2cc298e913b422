"""Datasets and batches for the port's entry points.

Counterpart of the host-loader path of ``sr3_tpu/data/loader.py``
(``create_dataset``, ``DataLoader``, ``create_dataloader``): the port's own
``LRHRDataset`` from a dataset config, a seeded shuffle per epoch,
``drop_last`` for training, and numpy collation of the dataset's NHWC items.

On a mesh each rank reads a disjoint part of every epoch, as the JAX
loader's processes do (``sr3_tpu/data/loader.py`` ``_batches``): every rank
shuffles with the same seed, cuts the epoch to whole global batches, and
takes every D-th index from its data coordinate on (D the data axis size),
in batches of ``batch_size / D``; the union of the ranks' batches at a step
is the global batch of that step. Ranks that share a data coordinate (model
and space peers) read the same indices in the same order. The val loader
is batch 1, unshuffled and unsharded, as the JAX one.
"""

from __future__ import annotations

import logging

import numpy as np

from sr3_tpu_torch.data.lrhr import LRHRDataset


def create_dataset(dataset_opt, phase):
    """The ``LRHRDataset`` of one ``datasets.{train,val}`` config; 'LRHR'
    mode also loads the LR images."""
    dataset = LRHRDataset(
        dataroot=dataset_opt["dataroot"],
        datatype=dataset_opt["datatype"],
        l_resolution=dataset_opt["l_resolution"],
        r_resolution=dataset_opt["r_resolution"],
        split=phase,
        data_len=(dataset_opt["data_len"]
                  if dataset_opt["data_len"] is not None else -1),
        need_LR=dataset_opt["mode"] == "LRHR",
        cache=dataset_opt.get("cache"),
    )
    logging.getLogger("base").info("Dataset [%s - %s] is created.",
                                   type(dataset).__name__, dataset_opt["name"])
    return dataset


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
                 seed=0, shard=(0, 1)):
        """``batch_size`` is the global batch; ``shard = (coordinate,
        size)`` of the data axis (size must divide the batch)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard = tuple(shard)
        if batch_size % self.shard[1]:
            raise ValueError(f"batch_size {batch_size} is the global batch; "
                             f"the data axis ({self.shard[1]}) must divide it")
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def indices(self):
        """This rank's index batches of one epoch (advances the shuffle)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        coord, size = self.shard
        if size > 1:
            idx = idx[:len(self) * self.batch_size][coord::size]
        per = self.batch_size // size
        return [idx[b * per:(b + 1) * per] for b in range(len(self))]

    def __iter__(self):
        for batch in self.indices():
            yield collate([self.dataset[int(i)] for i in batch])


def create_dataloader(dataset, dataset_opt, phase, mesh=None):
    """The train loader (the config's global batch size and shuffle,
    drop_last, this rank's data shard on a mesh) or the val loader (batch
    1, unshuffled, unsharded)."""
    if phase == "train":
        shard = (0, 1) if mesh is None else (mesh.data.rank, mesh.data.size)
        return DataLoader(dataset, batch_size=dataset_opt["batch_size"],
                          shuffle=bool(dataset_opt["use_shuffle"]),
                          drop_last=True, shard=shard)
    if phase == "val":
        return DataLoader(dataset, batch_size=1, shuffle=False)
    raise NotImplementedError(f"Dataloader [{phase}] is not found.")
