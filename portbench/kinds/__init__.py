"""Drivers of the traffic kinds. A traffic file's ``kind`` names the module
here that runs it: ``sample`` (a reverse chain stepped through the
window) or ``train`` (training steps on the resident set). Each module has
``run(opt, traffic, seed, seconds, trace, device, t_start, system=None)``
returning a ``Run``."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import torch


@dataclasses.dataclass
class Run:
    e2e: dict  # end-to-end metric name -> value
    attempted: int  # steps the window ran
    failed: int
    numbers: dict  # the compared numbers, before their limits
    memory_peak_bytes: int | None
    summary: dict  # what the per-layer readers read
    detail: dict = dataclasses.field(default_factory=dict)  # of the check


def driver(kind):
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r}")
    return importlib.import_module(f"portbench.kinds.{kind}")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device):
    if torch.device(device).type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def release(device):
    """Collect freed objects and return their cached blocks to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def load_library(device):
    """Load the program's kernel library (building it in the checkout on
    a first run), as its first kernel call would."""
    if torch.device(device).type == "cuda":
        from sr3_tpu_torch.ops import _build

        _build.load_library()


class SetupParts:
    """Seconds of each part of set-up: ``mark(name)`` closes the part
    that began at the last mark (the first began at the process's
    start), after a synchronize."""

    def __init__(self, t_start, device):
        self.device, self.t = device, t_start
        self.marks = {}
        self.mark("start")

    def mark(self, name):
        sync(self.device)
        now = time.time()
        self.marks[name] = now - self.t
        self.t = now


def host_spans(step, n, device):
    """Host milliseconds to issue ``step()`` from an idle device, ``n``
    times: a synchronize before each, none inside."""
    out = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        step()
        out.append((time.perf_counter() - t0) * 1e3)
    sync(device)
    return out
