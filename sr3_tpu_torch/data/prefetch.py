"""Device prefetch: the host-to-device copy of the next batches overlaps the
current training step.

The port's counterpart of ``sr3_tpu/data/prefetch.py``. ``device_prefetch``
wraps a batch iterator and keeps ``size`` batches in flight on the device.
Each 4-D numpy array of a batch (NHWC) becomes the NCHW tensor in
``torch.channels_last`` memory that ``Trainer.feed_data`` makes, float32;
other values pass through. On a CUDA device a thread of its own converts
each array into pinned host memory, so the thread that launches the
training step's kernels does not pay for it; the consumer's thread pulls
the batches from ``batches`` in order (the loader and its ``random`` draws
stay where they were) and queues each pinned tensor's ``non_blocking``
copy on a side stream once its pinning is done. The consumer's stream
waits on an event recorded after the copies, and ``record_stream`` tells
the caching allocator that the consumer's stream uses the tensor, so its
memory is not reused while that stream may still read it. On the CPU the
conversion is the same, inline and without streams. Under a mesh the
loader already yields this rank's rows, so only they are moved.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _to_nchw(v):
    """NHWC numpy -> NCHW float32 host tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)) \
        .permute(0, 3, 1, 2)


def _arrays(batch):
    return [k for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.ndim == 4]


def _pinned(batch):
    """The batch with its 4-D arrays as pinned NCHW host tensors (on the
    pinning thread), and their keys."""
    keys = _arrays(batch)
    return {**batch, **{k: _to_nchw(batch[k]).pin_memory() for k in keys}}, \
        keys


def device_prefetch(batches, device, size=2):
    """Yield the batches (dicts) of ``batches`` with their 4-D arrays on
    ``device``, ``size`` batches ahead of the consumer."""
    device = torch.device(device)
    if device.type != "cuda":
        buf = collections.deque()
        for batch in batches:
            buf.append({**batch, **{k: _to_nchw(batch[k])
                                    for k in _arrays(batch)}})
            if len(buf) > size:
                yield buf.popleft()
        yield from buf
        return
    side = torch.cuda.Stream(device)

    def copy(item):
        """Queue the copies of a pinned batch on the side stream (once)."""
        if item[1] is None:
            pinned, keys = item[0].result()
            with torch.cuda.stream(side):
                out = {**pinned, **{k: pinned[k].to(device, non_blocking=True)
                                    for k in keys}}
                ready = torch.cuda.Event()
                ready.record(side)
            item[1] = out, keys, ready
        return item[1]

    def take(item):
        out, keys, ready = copy(item)
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for k in keys:
            out[k].record_stream(stream)
        return out

    # [future of the pinned batch, its copies once queued], oldest first;
    # one pinning thread, so the futures complete in order
    buf = collections.deque()
    pinner = ThreadPoolExecutor(1, thread_name_prefix="device_prefetch")
    try:
        for batch in batches:
            buf.append([pinner.submit(_pinned, batch), None])
            for item in buf:  # the copies of every batch pinned by now
                if item[1] is None and not item[0].done():
                    break
                copy(item)
            if len(buf) > size:
                yield take(buf.popleft())
        while buf:
            yield take(buf.popleft())
    finally:
        pinner.shutdown(wait=True, cancel_futures=True)
