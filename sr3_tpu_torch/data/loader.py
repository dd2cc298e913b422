"""Datasets and batches for the port's entry points.

Counterpart of the host-loader path of ``sr3_tpu/data/loader.py``
(``create_dataset``, ``DataLoader``, ``create_dataloader``): the port's own
``LRHRDataset`` from a dataset config, a seeded shuffle per epoch,
``drop_last`` for training, and numpy collation of the dataset's NHWC items.
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
