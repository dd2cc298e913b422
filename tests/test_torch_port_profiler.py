"""The port's step timer and trace (sr3_tpu_torch/utils/profiler.py) against
the JAX package's (sr3_tpu/utils/profiler.py), and their wiring in the
port's trainer.

The same host clock readings give the same EMA stats in both timers; the
trainer ticks once per step and k times per resident call, logs the global
batch's images/s, and a schedule switch (validation in between) resets the
interval; trace() writes one TensorBoard trace when enabled and nothing
when not.
"""

import glob
import itertools
import json

import numpy as np
import pytest

import sr3_tpu.utils.profiler as jax_profiler
import sr3_tpu_torch.utils.profiler as profiler
from sr3_tpu_torch.training.trainer import create_model

from test_torch_port_driver import _config


def _clock(monkeypatch, module, times):
    it = iter(times)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


def test_step_timer_equals_the_jax_timers(monkeypatch):
    times = list(itertools.accumulate(
        np.random.default_rng(0).uniform(0.01, 0.3, 40)))
    ticks = [1, 1, 3, 1, 2] * 8
    port, jax = profiler.StepTimer(), jax_profiler.StepTimer()
    assert port.stats(4) == jax.stats(4) == {}
    with monkeypatch.context() as m:
        _clock(m, profiler, times)
        for n in ticks:
            port.tick(n)
    with monkeypatch.context() as m:
        _clock(m, jax_profiler, times)
        for n in ticks:
            jax.tick(n)
    for batch in (None, 4):
        assert port.stats(batch) == jax.stats(batch)
    assert set(port.stats(4)) == {"step_time_ms", "imgs_per_sec"}


def _trainer(tmp_path):
    opt = _config()
    opt["phase"] = "train"
    opt["model"]["diffusion"]["image_size"] = 16
    opt["path"]["checkpoint"] = str(tmp_path)
    return create_model(opt, device="cpu")


def test_trainer_ticks_and_a_phase_switch_resets(tmp_path, monkeypatch):
    t = _trainer(tmp_path)
    sched = t.opt["model"]["beta_schedule"]
    t.set_new_noise_schedule(sched["train"], "train")
    _clock(monkeypatch, profiler, [10.0, 10.5, 11.5, 20.0])
    batch = {k: np.zeros((2, 16, 16, 3), np.float32) for k in ("HR", "SR")}
    t.feed_data(batch)
    t.optimize_parameters()          # 10.0: first reading
    t.optimize_parameters()          # 10.5: 0.5 s
    assert t.get_current_log()["step_time_ms"] == pytest.approx(500)
    t.set_new_noise_schedule(sched["val"], "val")
    assert t.timer._last is None
    t.set_new_noise_schedule(sched["train"], "train")
    t.optimize_parameters()          # 11.5: first reading after the switch
    log = t.get_current_log()
    assert log["step_time_ms"] == pytest.approx(500)
    assert log["imgs_per_sec"] == pytest.approx(4.0)
    class Decoded(list):
        def _decoded(self, i):
            return self[i]

    t.load_device_dataset(Decoded([{k: np.zeros((16, 16, 3), np.uint8)
                                    for k in ("HR", "SR")}] * 3))
    t.data = None
    t.optimize_parameters_resident(3, 2)   # 20.0: 4.25 s a step
    ema = 0.95 * 0.5 + 0.05 * 4.25
    log = t.get_current_log()
    assert log["step_time_ms"] == pytest.approx(ema * 1e3)
    assert log["imgs_per_sec"] == pytest.approx(3 / ema)


def test_trace_writes_one_file_when_enabled(tmp_path):
    import torch

    x = torch.ones(64, 64)
    with profiler.trace(str(tmp_path / "off"), enabled=False):
        x @ x
    assert not (tmp_path / "off").exists()
    with profiler.trace(str(tmp_path / "on")):
        x @ x
    files = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
