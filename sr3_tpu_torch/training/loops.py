"""The training loop.

Counterpart of ``sr3_tpu/training/loops.py`` (``log_train_step``,
``train_loop``): cadenced logging, validation and checkpoints that fire
when the step counter crosses a multiple of their frequency, the
non-finite-loss guard (``train.nan_guard``: raise, warn or off) and a
checkpoint at the next step boundary after SIGTERM. With
``train.steps_per_dispatch`` K > 1 the loop gathers K batches and runs their
steps one after another before the cadences fire, as the JAX package's
fused K-step dispatch does. Host batches reach the trainer through
``data/prefetch.py``'s ``device_prefetch``, two batches ahead of the step.
With ``datasets.train.device_data`` the train
set is held on the device (``Trainer.load_device_dataset``) and each call of
``optimize_parameters_resident`` runs K steps on batches drawn there; no
host loader runs in the loop.
"""

from __future__ import annotations

import logging
import math
import signal

from sr3_tpu_torch.data.prefetch import device_prefetch

logger = logging.getLogger("base")


def log_train_step(trainer, current_epoch, current_step, tb_logger=None,
                   wandb_logger=None, nan_guard="raise"):
    """Log the trainer's current log dict; a non-finite loss raises
    FloatingPointError ("raise"), logs an error ("warn") or passes ("off").
    """
    logs = trainer.get_current_log()
    l_pix = logs.get("l_pix")
    if nan_guard != "off" and l_pix is not None and not math.isfinite(l_pix):
        msg = (
            "non-finite training loss l_pix={} at iter {:,d} (epoch {}) — "
            "the optimizer state is likely poisoned; resume from the last "
            "checkpoint with a lower lr / different seed. Set "
            "train.nan_guard to \"warn\" or \"off\" to continue anyway."
        ).format(l_pix, current_step, current_epoch)
        if nan_guard == "warn":
            logger.error(msg)
        else:
            raise FloatingPointError(msg)
    message = "<epoch:{:3d}, iter:{:8,d}> ".format(current_epoch, current_step)
    for k, v in logs.items():
        message += "{:s}: {:.4e} ".format(k, v)
        if tb_logger:
            tb_logger.add_scalar(k, v, current_step)
    logger.info(message)
    if wandb_logger:
        wandb_logger.log_metrics(logs)


class _PreemptionWatch:
    """Records a SIGTERM so the loop can checkpoint at the next step
    boundary (the handler itself only sets a flag). No-op outside the main
    thread or when not ``enabled``."""

    def __init__(self, enabled=True):
        self.signum = None
        self._installed = []
        if not enabled:
            return
        try:
            prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed.append((signal.SIGTERM, prev))
        except ValueError:  # not the main thread
            self._installed = []

    def _handler(self, signum, frame):
        self.signum = signum

    def fired(self):
        return self.signum is not None

    def restore(self):
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed = []


def train_loop(trainer, train_loader, opt, on_validate, tb_logger=None,
               wandb_logger=None):
    """Run the training phase to ``train.n_iter`` optimizer steps.

    ``on_validate(current_step, current_epoch)`` runs every
    ``train.val_freq`` steps; schedule switching is the callee's concern.
    """
    train_opt = opt["train"]
    device_data = bool(
        ((opt.get("datasets") or {}).get("train") or {}).get("device_data"))
    # the resident path draws with replacement when the batch exceeds the
    # set, so only the host loader can run out of batches
    if not device_data and len(train_loader) == 0:
        raise ValueError(
            "train loader yields zero batches: dataset has "
            f"{len(train_loader.dataset)} samples but batch_size="
            f"{train_loader.batch_size} with drop_last — lower the batch "
            "size or add data (the loop would otherwise spin forever)")
    current_step = trainer.begin_step
    current_epoch = trainer.begin_epoch
    n_iter = train_opt["n_iter"]
    spd = int(train_opt.get("steps_per_dispatch") or 1)
    nan_guard = train_opt.get("nan_guard") or "raise"
    log_wandb_ckpt = bool(wandb_logger and opt.get("log_wandb_ckpt"))
    watch = _PreemptionWatch(
        enabled=(train_opt.get("preempt_checkpoint") or "on") != "off")

    def crossed(freq, prev_step):
        return current_step // freq > prev_step // freq

    def cadences(prev_step):
        if crossed(train_opt["print_freq"], prev_step):
            log_train_step(trainer, current_epoch, current_step, tb_logger,
                           wandb_logger, nan_guard=nan_guard)
        if crossed(train_opt["val_freq"], prev_step):
            on_validate(current_step, current_epoch)
        if crossed(train_opt["save_checkpoint_freq"], prev_step):
            logger.info("Saving models and training states.")
            trainer.save_network(current_epoch, current_step)
            if log_wandb_ckpt:
                wandb_logger.log_checkpoint(current_epoch, current_step)

    def preempted():
        if not watch.fired():
            return False
        logger.warning("SIGTERM received (preemption?) — checkpointing at "
                       "iter %s and stopping.", "{:,d}".format(current_step))
        trainer.save_network(current_epoch, current_step)
        return True

    def epochs():
        """The endless batch stream, each batch tagged with its epoch before
        the prefetch, so the tag stays exact under its lookahead."""
        epoch = current_epoch
        while True:
            epoch += 1
            for b in train_loader:
                yield {**b, "_epoch": epoch}

    try:
        if device_data:
            trainer.load_device_dataset(train_loader.dataset)
            batch_size = train_loader.batch_size
            n = len(train_loader.dataset)
            while current_step < n_iter:
                k = min(spd, n_iter - current_step)
                trainer.optimize_parameters_resident(batch_size, k)
                prev_step = current_step
                current_step += k
                current_epoch = 1 + current_step * batch_size // max(n, 1)
                cadences(prev_step)
                if preempted():
                    break
            logger.info("End of training.")
            return
        chunk = []
        for train_data in device_prefetch(epochs(), trainer.device):
            if current_step >= n_iter:
                break
            epoch = train_data.pop("_epoch")
            if wandb_logger and epoch > current_epoch > 0:
                wandb_logger.log_metrics({"epoch": current_epoch})
            current_epoch = epoch
            chunk.append(train_data)
            if len(chunk) < spd and current_step + len(chunk) < n_iter:
                continue
            for batch in chunk:
                trainer.feed_data(batch)
                trainer.optimize_parameters()
            prev_step = current_step
            current_step += len(chunk)
            chunk = []
            cadences(prev_step)
            if preempted():
                break
        if wandb_logger and current_epoch > 0:
            wandb_logger.log_metrics({"epoch": current_epoch})
        logger.info("End of training.")
    finally:
        watch.restore()
