"""Gaussian diffusion: training losses and the reverse chains.

Counterpart of ``sr3_tpu/models/diffusion.py``. Two conditioning modes
share one implementation, as there:

- ``cond_mode='sr3'``: training draws one t per step and a continuous noise
  level per sample inside bin t; sampling conditions the net on
  ``sqrt_alphas_cumprod_prev[t+1]``;
- ``cond_mode='ddpm'``: training draws an integer t in [0, T) per sample
  and noises with ``q_sample_t``; the net is conditioned on float t.

Chains: the ancestral ``p_sample_loop`` (conditional, or unconditional from
a shape), ``interpolate`` (ddpm), the strided ``ddim_sample_loop`` and
``dpmpp_sample_loop`` (DPM-Solver++(2M), ODE or SDE). As in the JAX package
the network to run is passed in (the trainer passes its float32-parameter
network to the loss and its bf16 inference copy to the chains); the class
holds only configuration.

The JAX package compiles each chain into one ``lax.scan``; here each is a
Python loop whose every operation is queued on the device without a host
sync: t is a host integer, the schedule coefficients (and the strided
chains' tables, computed in float32 from the schedule as the JAX package
computes them) are indexed on the device, and noise is drawn on the device
from ``torch.Generator``s. Every chain takes ``noise_stream=(init, steps)``
to replace its draws (the parity-test seam). Image tensors are NCHW float32.
"""

from __future__ import annotations

import numpy as np
import torch

CL = torch.channels_last


def _snapshot_count(num_steps):
    """Frames kept by the reference's ``i % (1 | (S // 10)) == 0`` rule
    (bitwise OR, as in the reference), i counting the S steps down to 0."""
    inter = 1 | (num_steps // 10)
    return (num_steps - 1) // inter + 1, inter


def randn(shape, generator, device):
    """Standard normal noise of ``shape`` on ``device``. ``generator`` is
    one torch.Generator, or a list of one per image (the image's own
    stream, so a result does not depend on how images are grouped)."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for {shape[0]} images")
        return torch.cat([torch.randn((1,) + tuple(shape[1:]), generator=g,
                                      device=device) for g in generator])
    return torch.randn(shape, generator=generator, device=device)


def q_sample_gamma(x_start, sqrt_gamma, noise):
    """sr3 forward noising with a per-sample sqrt-gamma of shape (b, 1)."""
    g = sqrt_gamma.reshape(-1, 1, 1, 1)
    return g * x_start + torch.sqrt(1.0 - g ** 2) * noise


def q_sample_t(sched, x_start, t, noise):
    """ddpm forward noising at integer timesteps ``t`` of shape (b,)."""
    c1 = sched.sqrt_alphas_cumprod[t].reshape(-1, 1, 1, 1)
    c2 = sched.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1, 1)
    return c1 * x_start + c2 * noise


def _strided_taus(T, n_steps):
    """The ascending sub-schedule of the strided chains: n_steps (at most
    T) timesteps spread evenly over [0, T-1], duplicates dropped."""
    n_steps = min(n_steps, T)
    return np.unique(np.linspace(0, T - 1, n_steps).round().astype(np.int64))


class GaussianDiffusion:
    """Binds a UNet to the diffusion math (sr3 or ddpm conditioning)."""

    def __init__(self, denoise_fn, image_size, channels=3, loss_type="l1",
                 conditional=True, cond_mode="sr3"):
        if cond_mode not in ("sr3", "ddpm"):
            raise ValueError(f"cond_mode must be 'sr3' or 'ddpm', got "
                             f"{cond_mode!r}")
        self.denoise_fn = denoise_fn
        self.image_size = image_size
        self.channels = channels
        self.loss_type = loss_type
        self.conditional = conditional
        self.cond_mode = cond_mode

    # ------------------------------------------------------------------ loss

    def p_losses(self, net, sched, batch, generator=None, injected=None):
        """Training loss of ``net`` (in train mode for dropout). ``batch``
        holds NCHW float32 'HR' (and 'SR' when conditional) in [-1, 1] on
        the device; every draw (t, sqrt-gamma, noise, the dropout masks)
        comes from ``generator``. ``injected`` may hold ``noise`` (like HR)
        and, for sr3, ``sqrt_gamma`` (b, 1) or, for ddpm, ``t`` (b,)
        integers, replacing those draws (the parity-test seam). Returns the
        scalar sum-loss / (b*c*h*w)."""
        x_start = batch["HR"]
        b, device = x_start.shape[0], x_start.device
        injected = injected or {}
        noise = injected.get("noise")
        if noise is None:
            noise = randn(x_start.shape, generator, device)
        if self.cond_mode == "sr3":
            sqrt_gamma = injected.get("sqrt_gamma")
            if sqrt_gamma is None:
                t = torch.randint(1, sched.num_timesteps + 1, (1,),
                                  generator=generator, device=device)
                lo = sched.sqrt_alphas_cumprod_prev[t - 1]
                hi = sched.sqrt_alphas_cumprod_prev[t]
                sqrt_gamma = torch.rand((b, 1), generator=generator,
                                        device=device) * (hi - lo) + lo
            x_noisy = q_sample_gamma(x_start, sqrt_gamma, noise)
            cond_in = sqrt_gamma.reshape(b)
        else:
            t = injected.get("t")
            if t is None:
                t = torch.randint(0, sched.num_timesteps, (b,),
                                  generator=generator, device=device)
            t = torch.as_tensor(t, dtype=torch.long, device=device)
            x_noisy = q_sample_t(sched, x_start, t, noise)
            cond_in = t.float()
        net_in = (torch.cat([batch["SR"], x_noisy], 1) if self.conditional
                  else x_noisy)
        pred = net(net_in.contiguous(memory_format=CL), cond_in,
                   generator=generator)
        diff = noise - pred
        if self.loss_type == "l1":
            loss = diff.abs().sum()
        elif self.loss_type == "l2":
            loss = diff.square().sum()
        else:
            raise NotImplementedError(self.loss_type)
        return loss / x_start.numel()

    # -------------------------------------------------------------- sampling

    def _eps_at(self, net, sched, img, t, condition_x=None):
        """eps prediction at host timestep ``t`` with the mode's
        conditioning: sqrt_alphas_cumprod_prev[t+1] (sr3) or float t
        (ddpm)."""
        b = img.shape[0]
        if self.cond_mode == "sr3":
            lvl = sched.sqrt_alphas_cumprod_prev[t + 1].expand(b)
        else:
            lvl = torch.full((b,), float(t), device=img.device)
        net_in = img if condition_x is None else torch.cat([condition_x, img], 1)
        return net(net_in.contiguous(memory_format=CL), lvl)

    def p_sample_step(self, net, sched, img, t, condition_x=None,
                      clip_denoised=True, noise=None, generator=None):
        """One reverse step x_t -> x_{t-1}. ``t`` is a host int. ``noise``
        overrides the draw from ``generator`` (the parity-test seam)."""
        eps = self._eps_at(net, sched, img, t, condition_x)
        x_recon = (sched.sqrt_recip_alphas_cumprod[t] * img
                   - sched.sqrt_recipm1_alphas_cumprod[t] * eps)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean = (sched.posterior_mean_coef1[t] * x_recon
                + sched.posterior_mean_coef2[t] * img)
        if t == 0:  # the last step adds no noise
            return mean
        if noise is None:
            noise = randn(img.shape, generator, img.device)
        return mean + torch.exp(0.5 * sched.posterior_log_variance_clipped[t]) \
            * noise

    def _chain_start(self, net, x_in, generator, noise_stream):
        """(condition or None, shape, initial image, step noises or None)
        of a chain from a condition image or, unconditional, a shape."""
        if self.conditional:
            condition_x = x_in.float()
            shape, device = tuple(x_in.shape), x_in.device
        else:
            condition_x = None
            shape = tuple(x_in)
            device = next(net.parameters()).device
        if noise_stream is None:
            return condition_x, shape, randn(shape, generator, device), None
        init, steps = (torch.as_tensor(a, dtype=torch.float32, device=device)
                       for a in noise_stream)
        return condition_x, shape, init, steps

    def _frames(self, condition_x, img0, snaps):
        """Process frames ((1 + n_snap) * b, c, h, w): frame 0 is the
        condition, or the initial noise when unconditional."""
        first = condition_x if self.conditional else img0
        return torch.cat([first] + snaps, 0)

    def p_sample_loop(self, net, sched, x_in, generator=None,
                      continuous=False, clip_denoised=True,
                      noise_stream=None):
        """Full ancestral chain from the condition image ``x_in``
        (b,c,h,w), or from a shape tuple (b,c,h,w) when unconditional.

        Returns the final image, or with ``continuous`` the process frames
        ((1+n_snap)*b, c, h, w): frame 0 is the condition (unconditional:
        the initial noise), then every ``1 | (T//10)``-th step.
        ``noise_stream = (init, steps)`` of shapes (b,c,h,w) and
        (T,b,c,h,w) replaces every draw: steps[i] feeds loop position i
        (t = T-1-i), as in the JAX package."""
        T = sched.num_timesteps
        _, inter = _snapshot_count(T)
        condition_x, shape, img, step_noises = self._chain_start(
            net, x_in, generator, noise_stream)
        img0, snaps = img, []
        for i, t in enumerate(range(T - 1, -1, -1)):
            noise = None if step_noises is None else step_noises[i]
            img = self.p_sample_step(net, sched, img, t, condition_x,
                                     clip_denoised, noise=noise,
                                     generator=generator)
            if continuous and t % inter == 0:
                snaps.append(img)
        return self._frames(condition_x, img0, snaps) if continuous else img

    def ddim_sample_loop(self, net, sched, x_in, generator=None, n_steps=50,
                         eta=0.0, continuous=False, clip_denoised=True,
                         noise_stream=None):
        """DDIM (Song et al. 2020) over a strided sub-schedule of S =
        len(_strided_taus(T, n_steps)) timesteps, one net forward each;
        eta = 0 is deterministic given the initial noise, eta = 1 with S = T
        is the ancestral chain. With ``clip_denoised`` eps is re-derived
        from the clipped x0. Frames by ``_snapshot_count(S)`` over the loop
        position counting down S-1..0; ``noise_stream = (init, steps)``
        with steps (S,b,c,h,w) replaces the draws (none with eta = 0)."""
        T = sched.num_timesteps
        tau = _strided_taus(T, n_steps)
        S = len(tau)
        _, inter = _snapshot_count(S)
        condition_x, shape, img, step_noises = self._chain_start(
            net, x_in, generator, noise_stream)
        # per-step tables in sampling (descending-t) order, float32 on the
        # device as the JAX package computes them
        abar_asc = sched.alphas_cumprod[torch.as_tensor(
            tau, device=img.device)].float()
        abar_prev_asc = torch.cat([abar_asc.new_ones(1), abar_asc[:-1]])
        abar, abar_prev = abar_asc.flip(0), abar_prev_asc.flip(0)
        sigma = (eta * torch.sqrt((1 - abar_prev) / (1 - abar))
                 * torch.sqrt(1 - abar / abar_prev))
        dir_coef = torch.sqrt(torch.clamp(1 - abar_prev - sigma ** 2, min=0.0))
        sqrt_ab, sqrt_1mab = torch.sqrt(abar), torch.sqrt(1.0 - abar)
        sqrt_ab_prev = torch.sqrt(abar_prev)

        img0, snaps = img, []
        for i, t in enumerate(tau[::-1].tolist()):
            eps = self._eps_at(net, sched, img, t, condition_x)
            x0 = (img - sqrt_1mab[i] * eps) / sqrt_ab[i]
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
                eps = (img - sqrt_ab[i] * x0) / sqrt_1mab[i]
            img = sqrt_ab_prev[i] * x0 + dir_coef[i] * eps
            if eta > 0:
                noise = (randn(shape, generator, img.device)
                         if step_noises is None else step_noises[i])
                img = img + sigma[i] * noise
            if continuous and (S - 1 - i) % inter == 0:
                snaps.append(img)
        return self._frames(condition_x, img0, snaps) if continuous else img

    def dpmpp_sample_loop(self, net, sched, x_in, generator=None, n_steps=25,
                          eta=0.0, continuous=False, clip_denoised=True,
                          noise_stream=None):
        """DPM-Solver++(2M) (Lu et al. 2022) in data-prediction form over
        the strided sub-schedule, one net forward per step (the second-order
        correction reuses the previous step's x0). ``eta`` = 0: the
        probability-flow ODE, deterministic given the initial noise; > 0:
        SDE-DPM-Solver++(2M), fresh noise each step (use 1). The last step
        jumps to the x0 prediction, first order. Frames and
        ``noise_stream`` as ``ddim_sample_loop``."""
        T = sched.num_timesteps
        tau = _strided_taus(T, n_steps)
        S = len(tau)
        _, inter = _snapshot_count(S)
        condition_x, shape, img, step_noises = self._chain_start(
            net, x_in, generator, noise_stream)
        # At position i the net runs at tau_desc[i] and the state moves to
        # tau_desc[i+1] (the clean image after the last step). With
        # alpha = sqrt(abar), sigma = sqrt(1-abar),
        # lambda = log(alpha/sigma), h_i = lambda_next - lambda_cur > 0:
        #   x <- (sig_next/sig_cur) x + alpha_next (1 - e^{-h}) D
        #   D  = x0_i + (h_i / (2 h_{i-1})) (x0_i - x0_{i-1})   [2M]
        tau_desc = tau[::-1].copy()
        abar_cur = sched.alphas_cumprod[torch.as_tensor(
            tau_desc, device=img.device)].float()
        abar_next = torch.cat([abar_cur[1:], abar_cur.new_ones(1)])
        a_cur, s_cur = torch.sqrt(abar_cur), torch.sqrt(1.0 - abar_cur)
        a_next, s_next = torch.sqrt(abar_next), torch.sqrt(1.0 - abar_next)
        lam_cur = torch.log(a_cur) - torch.log(s_cur)
        # the final s_next is 0 (lambda -> inf): a finite stand-in keeps the
        # tables NaN-free, and the last step's coefficients are set to their
        # exact sigma -> 0 limits below
        lam_next = torch.log(a_next) - torch.log(torch.clamp(s_next, min=1e-20))
        h = lam_next - lam_cur
        h_prev = torch.cat([h.new_ones(1), h[:-1]])
        if eta > 0.0:
            c_lin = (s_next / s_cur) * torch.exp(-h)
            c_d = a_next * (1.0 - torch.exp(-2.0 * h))
            c_noise = eta * s_next * torch.sqrt(1.0 - torch.exp(-2.0 * h))
        else:
            c_lin = s_next / s_cur
            c_d = a_next * (1.0 - torch.exp(-h))
            c_noise = torch.zeros_like(c_lin)
        c_d1 = 0.5 * c_d * (h / h_prev)
        c_d1[0] = 0.0  # no history at the first step
        c_lin[-1], c_d[-1], c_d1[-1], c_noise[-1] = 0.0, 1.0, 0.0, 0.0

        img0, snaps, x0_prev = img, [], None
        for i, t in enumerate(tau_desc.tolist()):
            eps = self._eps_at(net, sched, img, t, condition_x)
            x0 = (img - s_cur[i] * eps) / a_cur[i]
            if clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            new = c_lin[i] * img + c_d[i] * x0
            if x0_prev is not None:
                new = new + c_d1[i] * (x0 - x0_prev)
            if eta > 0:
                noise = (randn(shape, generator, img.device)
                         if step_noises is None else step_noises[i])
                new = new + c_noise[i] * noise
            img, x0_prev = new, x0
            if continuous and (S - 1 - i) % inter == 0:
                snaps.append(img)
        return self._frames(condition_x, img0, snaps) if continuous else img

    def sample(self, net, sched, batch_size=1, generator=None,
               continuous=False):
        """Unconditional generation of ``batch_size`` images."""
        shape = (batch_size, self.channels, self.image_size, self.image_size)
        return self.p_sample_loop(net, sched, shape, generator, continuous)

    def super_resolution(self, net, sched, x_sr, generator=None,
                         continuous=False):
        """Conditional SR from the bicubic-upsampled LR image."""
        return self.p_sample_loop(net, sched, x_sr, generator, continuous)

    def interpolate(self, net, sched, x1, x2, generator=None, t=None,
                    lam=0.5, noise_stream=None):
        """Blend of two images noised to timestep t (default T-1), then the
        reverse chain from t-1 down to 0, as the JAX package (and the
        reference) step it (ddpm only). ``noise_stream = (n1, n2, steps)``
        of shapes like x1, x1 and (t,) + x1.shape replaces the draws."""
        if self.cond_mode != "ddpm":
            raise ValueError("interpolate is a ddpm-mode API")
        T = sched.num_timesteps
        t = T - 1 if t is None else int(t)
        b, device = x1.shape[0], x1.device
        if noise_stream is None:
            n1 = randn(x1.shape, generator, device)
            n2 = randn(x2.shape, generator, device)
            steps = None
        else:
            n1, n2, steps = (torch.as_tensor(a, dtype=torch.float32,
                                             device=device)
                             for a in noise_stream)
        tb = torch.full((b,), t, dtype=torch.long, device=device)
        img = ((1 - lam) * q_sample_t(sched, x1, tb, n1)
               + lam * q_sample_t(sched, x2, tb, n2))
        for i, ti in enumerate(range(t - 1, -1, -1)):
            img = self.p_sample_step(
                net, sched, img, ti, None, True, generator=generator,
                noise=None if steps is None else steps[i])
        return img
