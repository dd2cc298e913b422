"""Minimal in-tree LMDB stand-in: the port's own copy of
``sr3_tpu/data/fake_lmdb.py``, with the same on-disk format.

It implements the lmdb API surface the port uses -- ``open`` /
``Environment.begin`` / ``Transaction.get/put/stat/cursor`` -- so the lmdb
branches of ``data/lrhr.py`` (key scheme, ``length`` key,
resample-on-missing) and ``data/prepare.py --lmdb`` run on a machine
without the lmdb package (the card's machine has none). Tests inject it as
``sys.modules['lmdb']``; production can opt in the same way (it is a
correct, slow, single-file backend, not a performance substitute for
liblmdb).

Storage: one pickle of {bytes: bytes} at ``<path>/data.pkl``, so a store
written by either package's copy is read by the other's. Write
transactions buffer puts and publish atomically on a clean ``with`` exit,
mirroring lmdb's transactional semantics; an exception inside the block
discards the transaction's writes. The pickle is unpickled on open: open
only stores this program wrote.
"""

from __future__ import annotations

import builtins
import os
import pickle

_DB_FILE = "data.pkl"


class Transaction:
    def __init__(self, env: "Environment", write: bool):
        self._env = env
        self._write = write
        self._puts: dict | None = {} if write else None

    # -- lmdb.Transaction surface ------------------------------------------
    def get(self, key, default=None):
        key = bytes(key)
        if self._puts and key in self._puts:
            return self._puts[key]
        return self._env._data.get(key, default)

    def put(self, key, value):
        if not self._write:
            raise PermissionError("read-only transaction (lmdb: EACCES)")
        self._puts[bytes(key)] = bytes(value)
        return True

    def delete(self, key):
        if not self._write:
            raise PermissionError("read-only transaction (lmdb: EACCES)")
        key = bytes(key)
        existed = key in self._env._data or key in self._puts
        self._puts.pop(key, None)
        self._env._data.pop(key, None)
        return existed

    def stat(self):
        n = len(self._env._data | self._puts) if self._puts \
            else len(self._env._data)
        return {"entries": n, "depth": 1, "psize": 4096,
                "branch_pages": 0, "leaf_pages": 1, "overflow_pages": 0}

    def cursor(self):
        return iter(sorted(self._env._data.items()))

    def commit(self):
        if self._write and self._puts is not None:
            self._env._data.update(self._puts)
            self._env._persist()
            self._puts = {}

    def abort(self):
        self._puts = {} if self._write else None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        else:
            self.abort()
        return False


class Environment:
    def __init__(self, path, readonly=False, **_kw):
        self._path = path
        self._readonly = readonly
        self._file = os.path.join(path, _DB_FILE)
        if readonly:
            if not os.path.exists(self._file):
                raise FileNotFoundError(
                    f"No such file or directory: {self._file} "
                    "(lmdb: MDB_NOTFOUND)"
                )
        else:
            os.makedirs(path, exist_ok=True)
        if os.path.exists(self._file):
            with builtins.open(self._file, "rb") as f:
                self._data: dict = pickle.load(f)
        else:
            self._data = {}

    def _persist(self):
        tmp = self._file + ".tmp"
        with builtins.open(tmp, "wb") as f:
            pickle.dump(self._data, f)
        os.replace(tmp, self._file)

    # -- lmdb.Environment surface ------------------------------------------
    def begin(self, write=False, **_kw):
        if write and self._readonly:
            raise PermissionError("environment is read-only (lmdb: EACCES)")
        return Transaction(self, write)

    def stat(self):
        return Transaction(self, False).stat()

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def open(path, **kw):  # noqa: A001 - mirrors the lmdb module-level name
    return Environment(path, readonly=kw.pop("readonly", False), **kw)
