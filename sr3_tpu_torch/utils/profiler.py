"""Step timing and device traces of the port.

The port's own copy of ``sr3_tpu/utils/profiler.py``:

- ``StepTimer`` keeps an EMA of the host interval between optimizer steps
  and the images/s it gives, logged with the print-freq lines. It reads the
  host clock only: no device synchronization, so a step that is still
  running on the card when the host moves on counts at the host's pace, as
  the JAX timer counts dispatches;
- ``trace`` captures a ``torch.profiler`` trace of the CPU and CUDA
  activities into a directory, in the format TensorBoard's profiler plugin
  opens; with ``enabled`` false it writes nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger("base")


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


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Capture a CPU + CUDA trace of the block into ``log_dir`` (one
    ``*.pt.trace.json`` file, as ``tensorboard_trace_handler`` writes)."""
    if not enabled:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    logger.info("profiler trace started -> %s", log_dir)
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        logger.info("profiler trace written -> %s", log_dir)
