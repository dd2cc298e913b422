"""Step timing, program spans, counters and device traces of the port.

The port's own copy of ``sr3_tpu/utils/profiler.py``, and its one tracing
module:

- ``StepTimer`` keeps an EMA of the host interval between optimizer steps
  and the images/s it gives, logged with the print-freq lines. It reads the
  host clock only: no device synchronization, so a step that is still
  running on the card when the host moves on counts at the host's pace, as
  the JAX timer counts dispatches;
- ``span(name, device, **attrs)`` marks a phase of the program (a chain
  step, the trainer's forward, backward and optimizer, a plain backward).
  It records only while a ``torch.profiler`` session is active (``trace``
  starts one); otherwise it returns one shared no-op object and makes no
  CUDA call. A record keeps the name, the attributes, the thread, the
  parent span and the host start and end from ``time.time_ns()``, the
  epoch clock ``torch.profiler`` stamps its events with; on a CUDA
  ``device`` it also records a pair of timing events on the current stream
  (none while the stream is being captured into a graph), and its
  ``device_ms`` is the stream's time between them, idle included. Records
  stay in memory (the newest ``MAX_SPANS``): ``spans()`` returns them,
  ``reset_spans()`` clears them. No ``record_function``: a profiler reads
  those as device activity;
- ``Counter(name)`` counts always (one ``+= 1`` in ``.n``) and registers
  under its name; ``counts()`` returns every count. The kernel wrappers
  count their launches with it, ``models/unet.py`` the Blocks that take K1
  (``block.fused``) or the GroupNorm -> dropout -> conv route
  (``block.split``);
- ``trace`` captures a ``torch.profiler`` trace of the CPU and CUDA
  activities into a directory, in the format TensorBoard's profiler plugin
  opens, and appends the spans recorded inside it to the trace file as
  host-thread events; with ``enabled`` false it writes nothing.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import json
import logging
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("base")

# span records kept; older ones are dropped first
MAX_SPANS = 1 << 16


class StepTimer:
    """EMA step-time tracker. Call tick() once per optimizer step."""

    def __init__(self, ema=0.95):
        self.ema = ema
        self._last = None
        self.avg_s = None

    def tick(self, n_steps: int = 1):
        """Record that n_steps optimizer steps completed since the last call
        (n_steps > 1 for a call that runs several steps)."""
        now = time.perf_counter()
        if self._last is not None:
            dt = (now - self._last) / max(1, n_steps)
            self.avg_s = (
                dt if self.avg_s is None
                else self.ema * self.avg_s + (1 - self.ema) * dt
            )
        self._last = now

    def stats(self, batch_size=None):
        if self.avg_s is None:
            return {}
        out = {"step_time_ms": self.avg_s * 1e3}
        if batch_size:
            out["imgs_per_sec"] = batch_size / self.avg_s
        return out


# ------------------------------------------------------------------ counters

_counters = {}


class Counter:
    """A count kept in ``.n``, registered under ``name`` for ``counts()``."""

    def __init__(self, name):
        self.name = name
        self.n = 0
        _counters[name] = self

    def __repr__(self):
        return f"Counter({self.name}={self.n})"


def counts():
    """Every registered counter's count, by name."""
    return {name: c.n for name, c in _counters.items()}


# --------------------------------------------------------------------- spans

_records = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_open = []  # spans open in the process, oldest first
_open_lock = threading.Lock()
_event_pool = collections.defaultdict(list)  # device index -> free events


def _event(index):
    try:
        return _event_pool[index].pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One recorded span (see the module docstring): ``id``, ``name``,
    ``attrs``, ``thread`` (native id), ``parent`` (the id of the innermost
    span open on the thread, else of the newest open in the process, or
    None), ``start_ns`` / ``end_ns`` (``time.time_ns()``) and
    ``device_ms``."""

    __slots__ = ("id", "name", "attrs", "thread", "parent", "start_ns",
                 "end_ns", "_device", "_events", "_device_ms")

    def __init__(self, name, device, attrs):
        self.name, self.attrs = name, attrs
        self._device = device
        self._events = None
        self._device_ms = None
        self.end_ns = None

    def __enter__(self):
        self.id = next(_ids)
        self.thread = threading.get_native_id()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _open_lock:
            outer = stack[-1] if stack else (_open[-1] if _open else None)
            _open.append(self)
        self.parent = None if outer is None else outer.id
        stack.append(self)
        dev = self._device
        if (dev is not None and dev.type == "cuda"
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream(dev)
            start = _event(stream.device_index)
            start.record(stream)
            self._events = (start, _event(stream.device_index), stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._events[2])
        _local.stack.pop()
        with _open_lock:
            _open.remove(self)
        _records.append(self)
        return False

    @property
    def device_ms(self):
        """The stream's milliseconds from the span's start to its end (waits
        for the end), or None where no events were recorded."""
        if self._events is not None:
            start, end, stream = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
            _event_pool[stream.device_index].extend((start, end))
        return self._device_ms


def span(name, device=None, **attrs):
    """A context manager marking the phase ``name`` (see the module
    docstring). ``device``: a tensor or ``torch.device`` whose current
    stream the span times, when it is a CUDA device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    if isinstance(device, torch.Tensor):
        device = device.device
    return Span(name, device, attrs)


def spans():
    """The recorded spans (``Span``), oldest end first."""
    return list(_records)


def reset_spans():
    """Forget every recorded span."""
    _records.clear()


# --------------------------------------------------------------------- trace

def _append_spans(path, recorded):
    """Add ``recorded`` spans to the Chrome trace at ``path`` as complete
    ("X") events of their threads, in microseconds on the trace's clock."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for s in recorded:
        args = dict(s.attrs, span_id=s.id, parent=s.parent,
                    device_ms=s.device_ms)
        doc["traceEvents"].append({
            "ph": "X", "cat": "sr3_span", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Capture a CPU + CUDA trace of the block into ``log_dir`` (one
    ``*.pt.trace.json`` file, as ``tensorboard_trace_handler`` writes),
    with the spans recorded inside the block added to it."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    pattern = os.path.join(log_dir, "*.pt.trace.json")
    before = set(glob.glob(pattern))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    t0 = time.time_ns()
    prof.start()
    logger.info("profiler trace started -> %s", log_dir)
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        recorded = [s for s in spans() if s.start_ns >= t0]
        for path in sorted(set(glob.glob(pattern)) - before):
            _append_spans(path, recorded)
        logger.info("profiler trace written -> %s (%d spans)", log_dir,
                    len(recorded))
