"""Faults planted underneath the timed path, to show that the check fails
them. Each is a context manager that patches the program
(``sr3_tpu_torch``) for its duration:

serving (``GaussianDiffusion.p_sample_step``):
- ``unchanged``: the step returns its input state;
- ``half_batch``: the step runs the first half of the batch and returns
  the rest unchanged;
- ``answer_altered``: the step's outputs go to the wrong images (rolled by
  one along the batch).

training:
- ``unchanged``: Adam's step does nothing;
- ``half_batch``: the loss is the mean over the first half of the batch;
- ``answer_altered``: one leaf (the first matrix) moves double;
- ``leaf_flipped``: one leaf's gradient (the first attention block's qkv
  projection, 3C x C) reaches Adam negated, its norm unchanged, as a sign
  error in an attention backward would leave it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _diffusion():
    from sr3_tpu_torch.models.diffusion import GaussianDiffusion

    return GaussianDiffusion


def _adam():
    from sr3_tpu_torch.training.optim import Adam

    return Adam


def serving_unchanged():
    def make(orig):
        def step(self, net, sched, img, t, *a, **k):
            orig(self, net, sched, img, t, *a, **k)
            return img
        return step
    return _patched(_diffusion(), "p_sample_step", make)


def serving_half_batch():
    def make(orig):
        def step(self, net, sched, img, t, condition_x=None, *a, **k):
            h = img.shape[0] // 2
            out = orig(self, net, sched, img[:h], t, condition_x[:h], *a, **k)
            return torch.cat([out, img[h:]])
        return step
    return _patched(_diffusion(), "p_sample_step", make)


def serving_answer_altered():
    def make(orig):
        def step(self, *a, **k):
            return orig(self, *a, **k).roll(1, dims=0)
        return step
    return _patched(_diffusion(), "p_sample_step", make)


def train_unchanged():
    return _patched(_adam(), "step", lambda orig: lambda self, *a, **k: None)


def train_half_batch():
    def make(orig):
        def p_losses(self, net, sched, batch, *a, **k):
            h = batch["HR"].shape[0] // 2
            return orig(self, net, sched, {n: v[:h] for n, v in batch.items()},
                        *a, **k)
        return p_losses
    return _patched(_diffusion(), "p_losses", make)


def train_answer_altered():
    def make(orig):
        def step(self, *a, **k):
            p = next(p for g in self.param_groups for p in g["params"]
                     if p.dim() >= 2)
            before = p.detach().clone()
            out = orig(self, *a, **k)
            with torch.no_grad():
                p.add_(p - before)
            return out
        return step
    return _patched(_adam(), "step", make)


def train_leaf_flipped():
    def make(orig):
        def step(self, *a, **k):
            p = next(p for g in self.param_groups for p in g["params"]
                     if p.dim() >= 2 and p.shape[0] == 3 * p.shape[1])
            if p.grad is not None:
                p.grad.neg_()
            return orig(self, *a, **k)
        return step
    return _patched(_adam(), "step", make)


FAULTS = {
    "sample": {"unchanged": serving_unchanged,
               "half_batch": serving_half_batch,
               "answer_altered": serving_answer_altered},
    "train": {"unchanged": train_unchanged,
              "half_batch": train_half_batch,
              "answer_altered": train_answer_altered,
              "leaf_flipped": train_leaf_flipped},
}
