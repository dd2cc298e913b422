"""The port's host data pipeline (sr3_tpu_torch/data/loader.py with worker
threads, data/prefetch.py) against the JAX package's loader on the
committed fixtures (dataset/fixtures_16_128).

The index order does not depend on num_workers and equals the JAX
loader's (its Python path) for the same seed; val batches are bit-equal to
the JAX loader's; train batches are bit-equal inline under the same
``random`` seed, and equal up to each sample's horizontal flip with
workers (the flips draw from the module-level ``random`` in thread order,
as the JAX transform's do); a dataset that raises surfaces the error in the
consumer; a consumer that stops early stops the producer; device_prefetch
on the CPU keeps the order, the epoch tags and feed_data's layout.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

from sr3_tpu.data import loader as jax_loader
from sr3_tpu_torch.data import loader
from sr3_tpu_torch.data.prefetch import device_prefetch

TIMEOUT = 30


def _opt(root, phase, **kw):
    return {"name": "fixture", "mode": "HR", "dataroot": root,
            "datatype": "img", "l_resolution": 16, "r_resolution": 128,
            "data_len": -1, "batch_size": 2, "use_shuffle": True,
            "num_workers": 4, **kw}


def _datasets(root, phase):
    opt = _opt(root, phase)
    return loader.create_dataset(opt, phase), jax_loader.create_dataset(
        opt, phase)


def _jax_loader(ds, batch_size, shuffle, seed=0, num_workers=0):
    return jax_loader.DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                                 drop_last=shuffle, seed=seed,
                                 num_workers=num_workers, use_native=False)


@pytest.mark.parametrize("num_workers", [0, 4])
def test_index_order_equals_the_jax_loaders(fixture_root, num_workers):
    ds, jds = _datasets(fixture_root, "train")
    port = loader.DataLoader(ds, 2, shuffle=True, drop_last=True, seed=5,
                             num_workers=num_workers)
    jax = _jax_loader(jds, 2, True, seed=5)
    for _ in range(3):  # epochs: the shuffle advances alike
        want = [b.tolist() for b in jax._batches()]
        got = [b["Index"].tolist() for b in port]
        assert got == want and len(got) == 3


def test_val_batches_equal_the_jax_loaders(fixture_root):
    ds, jds = _datasets(fixture_root, "val")
    port = loader.create_dataloader(ds, _opt(fixture_root, "val"), "val")
    assert port.num_workers == 1 and port.batch_size == 1
    want = list(_jax_loader(jds, 1, False, num_workers=1))
    got = list(port)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in ("HR", "SR", "Index"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_train_batches_equal_the_jax_loaders(fixture_root):
    ds, jds = _datasets(fixture_root, "train")
    port = loader.create_dataloader(ds, _opt(fixture_root, "train"), "train")
    assert port.num_workers == 4
    random.seed(11)
    want = list(_jax_loader(jds, 2, True))
    port.num_workers = 0
    random.seed(11)
    got = list(port)
    for g, w in zip(got, want):
        for k in ("HR", "SR", "Index"):
            assert np.array_equal(g[k], w[k]), k
    # with workers: the same samples, each flipped or not
    port = loader.create_dataloader(ds, _opt(fixture_root, "train"), "train")
    for g, w in zip(port, _jax_loader(jds, 2, True)):
        assert np.array_equal(g["Index"], w["Index"])
        for i in range(2):
            hr, flip = w["HR"][i], w["HR"][i][:, ::-1]
            assert (np.array_equal(g["HR"][i], hr)
                    or np.array_equal(g["HR"][i], flip))


class Failing(list):
    def __getitem__(self, i):
        if i == 5:
            raise OSError("unreadable sample 5")
        return {"HR": np.full((2, 2, 3), i, np.float32)}


def _consume(it, out):
    def run():
        try:
            for b in it:
                out.append(b)
        except OSError as e:
            out.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), "the consumer is blocked"


@pytest.mark.parametrize("num_workers", [0, 3])
def test_a_failing_dataset_raises_in_the_consumer(num_workers):
    out = []
    _consume(loader.DataLoader(Failing(range(8)), 2,
                               num_workers=num_workers), out)
    assert [b["HR"][:, 0, 0, 0].tolist() for b in out[:2]] == [[0, 1], [2, 3]]
    assert len(out) == 3 and "sample 5" in str(out[2])


def test_an_early_stop_ends_the_producer():
    before = threading.active_count()
    data = [{"HR": np.zeros((2, 2, 3), np.float32)}] * 64
    it = iter(loader.DataLoader(data, 2, num_workers=2, prefetch=1))
    next(it)
    it.close()
    deadline = time.monotonic() + TIMEOUT
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


def test_device_prefetch_on_the_cpu_keeps_order_and_tags():
    rng = np.random.default_rng(0)
    batches = [{"HR": rng.standard_normal((2, 4, 6, 3)).astype(np.float32),
                "Index": np.array([2 * i, 2 * i + 1]), "_epoch": 1 + i // 3}
               for i in range(7)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(len(pulled))
            yield b

    out = []
    for b in device_prefetch(source(), "cpu", size=2):
        # two batches ahead of the consumer, not more
        assert len(pulled) - len(out) <= 3
        out.append(b)
    assert [b["_epoch"] for b in out] == [b["_epoch"] for b in batches]
    for b, src in zip(out, batches):
        assert np.array_equal(b["Index"], src["Index"])
        x = b["HR"]
        assert x.shape == (2, 3, 4, 6) and x.dtype == torch.float32
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert np.array_equal(x.permute(0, 2, 3, 1).numpy(), src["HR"])
