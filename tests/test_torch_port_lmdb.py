"""The port's LMDB branch (sr3_tpu_torch/data/lrhr.py, data/prepare.py
--lmdb) through its own in-tree backend (sr3_tpu_torch/data/fake_lmdb.py),
against the JAX package's.

A store written by the port's prepare --lmdb is read by the JAX
LRHRDataset (JAX fake_lmdb as lmdb) and a store written by the JAX prepare
by the port's dataset (the port's fake_lmdb as lmdb), item for item, bit
for bit; also with neither cv2 nor Pillow on the port's side (its PNG
codec). The length key, data_len truncation, resample-on-missing and the
fake's transactions behave as tests/test_lmdb.py checks for the JAX
package.
"""

import os
import random
import sys

import numpy as np
import pytest
from PIL import Image

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu.data import LRHRDataset as JaxDataset
from sr3_tpu.data import fake_lmdb as jax_fake_lmdb
from sr3_tpu.data.prepare import prepare as jax_prepare
from sr3_tpu_torch.data import fake_lmdb
from sr3_tpu_torch.data.loader import DataLoader
from sr3_tpu_torch.data.lrhr import LRHRDataset
from sr3_tpu_torch.data.prepare import prepare

L, R, N = 8, 16, 4


@pytest.fixture()
def sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(7)
    for i in range(N):
        arr = rng.integers(0, 256, (24, 20 + 4 * i, 3), dtype=np.uint8)
        Image.fromarray(arr, "RGB").save(src / f"{i}.png")
    return str(src)


def _store(tmp_path, sources, writer, monkeypatch):
    """prepare --lmdb by ``writer`` ("port" or "jax"), each with its own
    package's fake_lmdb as lmdb."""
    out = str(tmp_path / f"{writer}_lmdb")
    fake, fn = ((fake_lmdb, prepare) if writer == "port"
                else (jax_fake_lmdb, jax_prepare))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "lmdb", fake)
        fn(sources, out, sizes=(L, R), lmdb_save=True)
    return out


def _items(cls, root, fake, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "lmdb", fake)
        ds = cls(root, "lmdb", l_resolution=L, r_resolution=R, split="val",
                 need_LR=True, **kw)
        return [ds[i] for i in range(len(ds))]


def _assert_equal(got, want):
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("HR", "SR", "LR"):
            assert g[k].dtype == w[k].dtype == np.float32
            assert np.array_equal(g[k], w[k]), k
        assert g["Index"] == w["Index"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_cross_read_bit_for_bit(tmp_path, sources, writer,
                                       monkeypatch):
    root = _store(tmp_path, sources, writer, monkeypatch)
    want = _items(JaxDataset, root, jax_fake_lmdb, monkeypatch)
    _assert_equal(_items(LRHRDataset, root, fake_lmdb, monkeypatch), want)
    # the card's machine: neither cv2 nor Pillow, the port's PNG codec
    monkeypatch.setattr(Metrics, "_cv2", lambda: None)
    monkeypatch.setattr(Metrics, "_pil_image", lambda: None)
    _assert_equal(_items(LRHRDataset, root, fake_lmdb, monkeypatch,
                         cache=False), want)


def test_key_scheme_and_length(tmp_path, sources, monkeypatch):
    root = _store(tmp_path, sources, "port", monkeypatch)
    env = fake_lmdb.open(root, readonly=True)
    with env.begin(write=False) as txn:
        assert txn.get(b"length") == str(N).encode()
        for i in range(N):
            idx = str(i).zfill(5)
            for key in (f"hr_{R}_{idx}", f"sr_{L}_{R}_{idx}", f"lr_{L}_{idx}"):
                assert txn.get(key.encode())[:8] == b"\x89PNG\r\n\x1a\n", key
        assert txn.stat()["entries"] == 3 * N + 1
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    for data_len, want in ((-1, N), (2, 2), (99, N)):
        ds = LRHRDataset(root, "lmdb", l_resolution=L, r_resolution=R,
                         split="val", data_len=data_len)
        assert len(ds) == want and ds.dataset_len == N


def test_resample_on_missing_and_train_batches(tmp_path, sources,
                                               monkeypatch):
    root = _store(tmp_path, sources, "port", monkeypatch)
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    env = fake_lmdb.open(root)
    with env.begin(write=True) as txn:
        assert txn.delete(f"hr_{R}_00001".encode())
    ds = LRHRDataset(root, "lmdb", l_resolution=L, r_resolution=R,
                     split="val", cache=False)
    valid = [ds[i]["HR"] for i in (0, 2, 3)]
    random.seed(3)
    got = ds[1]["HR"]  # some valid sample, not an error
    assert any(np.array_equal(got, v) for v in valid)
    train = LRHRDataset(root, "lmdb", l_resolution=L, r_resolution=R,
                        split="train")
    batch = next(iter(DataLoader(train, 2, shuffle=True, drop_last=True,
                                 num_workers=2)))
    assert batch["HR"].shape == (2, R, R, 3) and batch["HR"].dtype == np.float32


def test_fake_lmdb_transactions(tmp_path):
    path = str(tmp_path / "db")
    env = fake_lmdb.open(path)
    with env.begin(write=True) as txn:
        txn.put(b"a", b"1")
    with pytest.raises(RuntimeError):
        with env.begin(write=True) as txn:
            txn.put(b"b", b"2")
            raise RuntimeError("boom")
    reread = fake_lmdb.open(path, readonly=True)
    with reread.begin(write=False) as txn:
        assert txn.get(b"a") == b"1"
        assert txn.get(b"b") is None  # the aborted transaction's put
        assert list(txn.cursor()) == [(b"a", b"1")]
    with pytest.raises(PermissionError):
        reread.begin(write=True)
    with pytest.raises(FileNotFoundError):
        fake_lmdb.open(str(tmp_path / "missing"), readonly=True)
    # the JAX package's copy reads the port's store
    with jax_fake_lmdb.open(path, readonly=True).begin() as txn:
        assert txn.get(b"a") == b"1"
    assert os.path.isfile(os.path.join(path, "data.pkl"))
