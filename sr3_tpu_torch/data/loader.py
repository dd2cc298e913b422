"""Datasets and batches for the port's entry points.

Counterpart of the host-loader path of ``sr3_tpu/data/loader.py``
(``create_dataset``, ``DataLoader``, ``create_dataloader``): the port's own
``LRHRDataset`` from a dataset config, a seeded shuffle per epoch,
``drop_last`` for training, numpy collation of the dataset's NHWC items,
and the JAX loader's concurrency: with ``num_workers`` > 0 a producer
thread fetches the items of each batch on a ``ThreadPoolExecutor`` of that
many threads and puts the collated batch on a queue of ``prefetch`` (2)
batches; an exception in the producer is put on the queue and raised by the
consumer, and a consumer that stops early stops the producer. The batches
and their order do not depend on ``num_workers`` (``map`` keeps order); the
train split's flips draw from the module-level ``random`` as the JAX
transform does, so with workers they follow the threads' order, as there.

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
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

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
                 seed=0, shard=(0, 1), num_workers=0, prefetch=2):
        """``batch_size`` is the global batch; ``shard = (coordinate,
        size)`` of the data axis (size must divide the batch);
        ``num_workers`` 0 loads inline, more loads on that many threads
        behind a producer thread, ``prefetch`` batches ahead."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.prefetch = prefetch
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

    def _load(self, batch, mapfn):
        return collate(list(mapfn(lambda i: self.dataset[int(i)], batch)))

    def __iter__(self):
        if self.num_workers == 0:
            for batch in self.indices():
                yield self._load(batch, map)
            return
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            """Put unless the consumer has stopped; False once it has."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch in self.indices():
                        if not put(self._load(batch, pool.map)):
                            return
            except BaseException as e:  # noqa: BLE001 - raised by the consumer
                put(e)
            else:
                put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


def create_dataloader(dataset, dataset_opt, phase, mesh=None):
    """The train loader (the config's global batch size, shuffle and
    ``num_workers``, drop_last, this rank's data shard on a mesh) or the val
    loader (batch 1, unshuffled, unsharded, one worker)."""
    if phase == "train":
        shard = (0, 1) if mesh is None else (mesh.data.rank, mesh.data.size)
        return DataLoader(dataset, batch_size=dataset_opt["batch_size"],
                          shuffle=bool(dataset_opt["use_shuffle"]),
                          drop_last=True, shard=shard,
                          num_workers=dataset_opt.get("num_workers", 0) or 0)
    if phase == "val":
        return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=1)
    raise NotImplementedError(f"Dataloader [{phase}] is not found.")
