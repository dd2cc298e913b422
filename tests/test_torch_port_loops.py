"""The port's train loop on a fake trainer: exact step counts with
steps_per_dispatch, cadences that fire on crossing, the nan_guard modes, the
zero-batch guard, resume counters and the SIGTERM checkpoint, as
tests/test_loops.py checks the JAX package's loop."""

import logging
import os
import signal

import numpy as np
import pytest

from sr3_tpu_torch.training.loops import train_loop


class FakeTrainer:
    device = "cpu"  # where the loop's device_prefetch puts the batches

    def __init__(self, loss=0.5):
        self.begin_step = 0
        self.begin_epoch = 0
        self.loss = loss
        self.steps_run = 0
        self.saves = []
        self.on_step = None
        self.resident_calls = []

    def feed_data(self, data):
        self.data = data

    def optimize_parameters(self):
        self.steps_run += 1
        if self.on_step:
            self.on_step(self.steps_run)

    def load_device_dataset(self, dataset):
        self.resident_set = dataset

    def optimize_parameters_resident(self, batch_size, k_steps):
        self.resident_calls.append((batch_size, k_steps))

    def get_current_log(self):
        return {"l_pix": self.loss}

    def save_network(self, epoch, iter_step):
        self.saves.append((epoch, iter_step))


class Loader(list):
    batch_size = 2
    dataset = range(8)


def _loader(n):
    return Loader({"HR": np.zeros((2, 4, 4, 3), np.float32)} for _ in range(n))


def _opt(n_iter, spd=1, val_freq=10**9, ckpt_freq=10**9, print_freq=10**9,
         nan_guard=None):
    return {"train": {"n_iter": n_iter, "steps_per_dispatch": spd,
                      "print_freq": print_freq, "val_freq": val_freq,
                      "save_checkpoint_freq": ckpt_freq,
                      "nan_guard": nan_guard},
            "log_wandb_ckpt": False}


@pytest.mark.parametrize("n_iter,spd", [(7, 1), (5, 2), (48, 16)])
def test_exact_step_count(n_iter, spd):
    t = FakeTrainer()
    train_loop(t, _loader(4), _opt(n_iter, spd), lambda s, e: None)
    assert t.steps_run == n_iter


def test_cadences_fire_on_crossing():
    t = FakeTrainer()
    val_at = []
    train_loop(t, _loader(4), _opt(6, val_freq=2, ckpt_freq=3),
               lambda s, e: val_at.append(s))
    assert val_at == [2, 4, 6]
    assert [s for _, s in t.saves] == [3, 6]
    # steps_per_dispatch 16 does not divide val_freq 10: 16, 32, 48 cross it
    t, val_at = FakeTrainer(), []
    train_loop(t, _loader(60), _opt(48, spd=16, val_freq=10),
               lambda s, e: val_at.append(s))
    assert val_at == [16, 32, 48]
    t = FakeTrainer()
    train_loop(t, _loader(20), _opt(10, spd=3, ckpt_freq=7), lambda s, e: None)
    assert [s for _, s in t.saves] == [9]


def test_epochs_and_resume_counters():
    t = FakeTrainer()
    t.begin_step, t.begin_epoch = 4, 2
    train_loop(t, _loader(4), _opt(10, ckpt_freq=6), lambda s, e: None)
    assert t.steps_run == 6
    assert t.saves == [(3, 6)]  # steps 5-8 in epoch 3


@pytest.mark.parametrize("mode", ["raise", "warn", "off"])
def test_nan_guard_modes(mode, caplog):
    t = FakeTrainer(loss=float("nan"))
    run = lambda: train_loop(t, _loader(4), _opt(4, print_freq=2,
                                                 nan_guard=mode),
                             lambda s, e: None)
    if mode == "raise":
        with pytest.raises(FloatingPointError, match="non-finite"):
            run()
        assert t.steps_run == 2
        return
    with caplog.at_level(logging.INFO, logger="base"):
        run()
    assert t.steps_run == 4
    errors = [r for r in caplog.records if "non-finite" in r.getMessage()]
    assert len(errors) == (2 if mode == "warn" else 0)


def test_zero_batches_and_device_data_raise():
    """Zero host batches raise. device_data (ported since) does not: the
    loop holds the loader's dataset on the device and runs K resident steps
    a call, even when the loader has no batch (the resident draws take
    samples with replacement), epochs counted in samples as the JAX loop
    counts them."""
    with pytest.raises(ValueError, match="zero batches"):
        train_loop(FakeTrainer(), _loader(0), _opt(4), lambda s, e: None)
    opt = _opt(5, spd=2, ckpt_freq=4)
    opt["datasets"] = {"train": {"device_data": True}}
    t, loader = FakeTrainer(), _loader(0)
    train_loop(t, loader, opt, lambda s, e: None)
    assert t.resident_set is loader.dataset and t.steps_run == 0
    assert t.resident_calls == [(2, 2), (2, 2), (2, 1)]
    assert t.saves == [(2, 4)]  # epoch 1 + 4 * 2 // 8


def test_sigterm_checkpoints_and_stops():
    t = FakeTrainer()
    t.on_step = lambda n: n == 3 and os.kill(os.getpid(), signal.SIGTERM)
    before = signal.getsignal(signal.SIGTERM)
    train_loop(t, _loader(4), _opt(10), lambda s, e: None)
    assert t.steps_run == 3 and t.saves == [(1, 3)]
    assert signal.getsignal(signal.SIGTERM) is before
