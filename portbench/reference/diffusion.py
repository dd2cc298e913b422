"""SR3's diffusion arithmetic in plain PyTorch: the benchmark's reference
for a reverse-chain step, the training loss with its random draws, the
resident-set batch and Adam.

Follows the published SR3 training and sampling (Saharia et al. 2021;
Janspiry's ``model/sr3_modules/diffusion.py``): a noise level drawn
uniformly between sqrt(gamma_{t-1}) and sqrt(gamma_t) for one t per step,
x_noisy = g x0 + sqrt(1 - g^2) noise, an L1 loss summed and divided by the
element count; the ancestral step conditioned on sqrt(gamma_{t+1}), with
the clipped x0 estimate and the posterior's mean and variance. Every
coefficient is float64 numpy cast to float32, arithmetic float32.

Random draws are those a run makes on its device, call for call, so that
the reference sees the same numbers: per training step a generator seeded
from (seed, step) gives the batch's indices and flips, then the loss's
noise, t, level and dropout masks; a chain step's noise comes from the
generator state recorded before the step.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.unet import build


def fold_seed(base_seed, index):
    """The 64-bit seed of stream ``index`` under ``base_seed``."""
    return int(np.random.SeedSequence([base_seed, index])
               .generate_state(1, np.uint64)[0])


def betas(opt):
    """The beta schedule of a ``beta_schedule`` group, float64."""
    n = int(opt["n_timestep"])
    lo, hi = opt.get("linear_start", 1e-4), opt.get("linear_end", 2e-2)
    kind = opt["schedule"]
    if kind == "linear":
        return np.linspace(lo, hi, n, dtype=np.float64)
    if kind == "quad":
        return np.linspace(lo ** 0.5, hi ** 0.5, n, dtype=np.float64) ** 2
    if kind == "const":
        return np.full(n, hi, dtype=np.float64)
    raise NotImplementedError(f"schedule {kind!r}")


class Schedule:
    """The coefficient tables of one beta schedule, float32 on ``device``."""

    def __init__(self, opt, device):
        b = betas(opt)
        a = np.cumprod(1.0 - b)
        a_prev = np.append(1.0, a[:-1])
        var = b * (1.0 - a_prev) / (1.0 - a)
        tables = {
            "sqrt_gamma_prev": np.sqrt(np.append(1.0, a)),
            "sqrt_recip": np.sqrt(1.0 / a),
            "sqrt_recipm1": np.sqrt(1.0 / a - 1.0),
            "coef1": b * np.sqrt(a_prev) / (1.0 - a),
            "coef2": (1.0 - a_prev) * np.sqrt(1.0 - b) / (1.0 - a),
            "log_var": np.log(np.maximum(var, 1e-20)),
        }
        for k, v in tables.items():
            setattr(self, k, torch.from_numpy(v.astype(np.float32)).to(device))
        self.T = len(b)


def chain_eps(unet, sched, cond, x, t, prec):
    """The network's noise estimate at host timestep ``t``."""
    level = sched.sqrt_gamma_prev[t + 1].expand(x.shape[0])
    return unet(torch.cat([cond, x], 1), level, prec)


def chain_step(sched, x, t, eps, noise):
    """x_{t-1} from x_t and the noise estimate; ``noise`` is unused at
    t = 0."""
    x0 = (sched.sqrt_recip[t] * x - sched.sqrt_recipm1[t] * eps).clamp(-1, 1)
    mean = sched.coef1[t] * x0 + sched.coef2[t] * x
    if t == 0:
        return mean
    return mean + torch.exp(0.5 * sched.log_var[t]) * noise


def resident_draws(g, n, batch, device):
    """One step's sample indices and left-right flips."""
    if batch <= n <= 4096:
        idx = torch.randperm(n, generator=g, device=device)[:batch]
    else:
        idx = torch.randint(0, n, (batch,), generator=g, device=device)
    flip = torch.rand(batch, generator=g, device=device) < 0.5
    return idx, flip


def resident_batch(data, idx, flip):
    """NHWC uint8 arrays on the device -> NCHW float32 in [-1, 1]."""
    out = {}
    for k, v in data.items():
        x = v[idx].float() / 255.0 * 2.0 - 1.0
        x = torch.where(flip.reshape(-1, 1, 1, 1), x.flip(2), x)
        out[k] = x.permute(0, 3, 1, 2).contiguous()
    return out


def loss_draws(g, sched, hr_shape, device):
    """The loss's noise and per-sample noise level, in the order drawn."""
    b = hr_shape[0]
    noise = torch.randn(hr_shape, generator=g, device=device)
    t = torch.randint(1, sched.T + 1, (1,), generator=g, device=device)
    lo, hi = sched.sqrt_gamma_prev[t - 1], sched.sqrt_gamma_prev[t]
    level = torch.rand((b, 1), generator=g, device=device) * (hi - lo) + lo
    return noise, level


def dropout_sites(opt, batch):
    """Shapes of the dropout masks a training forward of ``batch`` images
    draws, in order, found by a forward on the meta device."""
    shapes = []

    def record(shape):
        shapes.append(shape)
        return torch.ones(shape, dtype=torch.bool, device="meta")

    net = build(opt, "meta")
    u, size = opt["model"]["unet"], opt["model"]["diffusion"]["image_size"]
    net(torch.zeros(batch, u["in_channel"], size, size, device="meta"),
        torch.zeros(batch, device="meta"), masks=record)
    return shapes


def draw_masks(g, shapes, keep, device):
    """Boolean keep-masks, True with probability ``keep``: float32 uniforms
    over tensors in channels-last memory, as a training forward draws
    them."""
    out = []
    for shape in shapes:
        u = torch.empty(shape, dtype=torch.float32, device=device,
                        memory_format=torch.channels_last)
        out.append(u.uniform_(generator=g) < keep)
    return out


def loss_and_grads(unet, sched, batch, noise, level, masks, prec,
                   rows_per_block):
    """The L1 loss sum / element count of one batch, with the gradients
    accumulated into ``unet``'s parameters (which must require grad),
    computed ``rows_per_block`` images at a time. Returns the loss."""
    x0, sr = batch["HR"], batch["SR"]
    b = x0.shape[0]
    total = 0.0
    for r0 in range(0, b, rows_per_block):
        rows = slice(r0, min(b, r0 + rows_per_block))
        g = level[rows].reshape(-1, 1, 1, 1)
        x_noisy = g * x0[rows] + torch.sqrt(1.0 - g ** 2) * noise[rows]
        it = iter([m[rows] for m in masks])
        pred = unet(torch.cat([sr[rows], x_noisy], 1), level[rows].reshape(-1),
                    prec, masks=lambda shape: next(it))
        part = (noise[rows] - pred).abs().sum() / x0.numel()
        part.backward()
        total += float(part.detach())
    return total


class Adam:
    """Adam as optax's ``scale_by_adam`` computes it, float32 moments."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))
