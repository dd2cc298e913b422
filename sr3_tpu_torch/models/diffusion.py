"""Gaussian diffusion: the sr3 training loss and ancestral reverse chain.

Counterpart of ``sr3_tpu/models/diffusion.py`` (``q_sample_gamma``,
``p_losses``, ``p_sample_step``, ``p_sample_loop``, ``super_resolution``) in
``cond_mode='sr3'``: training draws one t per step and a continuous noise
level per sample inside bin t; sampling conditions the net on
``sqrt_alphas_cumprod_prev[t+1]``. As in the JAX package the network to run
is passed in (the trainer passes its float32-parameter network to the loss
and its bf16 inference copy to the chain); the class holds only
configuration.

The JAX package compiles the chain into one ``lax.scan``; here it is a Python
loop over t whose every operation is queued on the device without a host
sync: ``t`` is a host integer, the schedule coefficients are indexed on the
device, and noise is drawn on the device from ``torch.Generator``s. Image
tensors are NCHW float32.
"""

from __future__ import annotations

import torch

CL = torch.channels_last


def _snapshot_count(num_timesteps):
    """Frames kept by the reference's ``t % (1 | (T // 10)) == 0`` rule
    (bitwise OR, as in the reference)."""
    inter = 1 | (num_timesteps // 10)
    return (num_timesteps - 1) // inter + 1, inter


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


class GaussianDiffusion:
    """Binds a UNet to the diffusion math (sr3 conditioning)."""

    def __init__(self, denoise_fn, image_size, channels=3, loss_type="l1",
                 conditional=True, cond_mode="sr3"):
        if cond_mode != "sr3":
            raise NotImplementedError(f"cond_mode {cond_mode!r} is not ported yet")
        self.denoise_fn = denoise_fn
        self.image_size = image_size
        self.channels = channels
        self.loss_type = loss_type
        self.conditional = conditional
        self.cond_mode = cond_mode

    def p_losses(self, net, sched, batch, generator=None, injected=None):
        """Training loss of ``net`` (in train mode for dropout). ``batch``
        holds NCHW float32 'HR' (and 'SR' when conditional) in [-1, 1] on
        the device; every draw (t, sqrt-gamma, noise, the dropout masks)
        comes from ``generator``. ``injected`` may hold ``noise`` (like HR)
        and ``sqrt_gamma`` (b, 1), replacing those draws (the parity-test
        seam). Returns the scalar sum-loss / (b*c*h*w)."""
        x_start = batch["HR"]
        b, device = x_start.shape[0], x_start.device
        injected = injected or {}
        noise = injected.get("noise")
        if noise is None:
            noise = randn(x_start.shape, generator, device)
        sqrt_gamma = injected.get("sqrt_gamma")
        if sqrt_gamma is None:
            t = torch.randint(1, sched.num_timesteps + 1, (1,),
                              generator=generator, device=device)
            lo = sched.sqrt_alphas_cumprod_prev[t - 1]
            hi = sched.sqrt_alphas_cumprod_prev[t]
            sqrt_gamma = torch.rand((b, 1), generator=generator,
                                    device=device) * (hi - lo) + lo
        x_noisy = q_sample_gamma(x_start, sqrt_gamma, noise)
        net_in = (torch.cat([batch["SR"], x_noisy], 1) if self.conditional
                  else x_noisy)
        pred = net(net_in.contiguous(memory_format=CL), sqrt_gamma.reshape(b),
                   generator=generator)
        diff = noise - pred
        if self.loss_type == "l1":
            loss = diff.abs().sum()
        elif self.loss_type == "l2":
            loss = diff.square().sum()
        else:
            raise NotImplementedError(self.loss_type)
        return loss / x_start.numel()

    def p_sample_step(self, net, sched, img, t, condition_x=None,
                      clip_denoised=True, noise=None, generator=None):
        """One reverse step x_t -> x_{t-1}. ``t`` is a host int. ``noise``
        overrides the draw from ``generator`` (the parity-test seam)."""
        b = img.shape[0]
        lvl = sched.sqrt_alphas_cumprod_prev[t + 1].expand(b)
        net_in = img if condition_x is None else torch.cat([condition_x, img], 1)
        eps = net(net_in.contiguous(memory_format=CL), lvl)

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

    def p_sample_loop(self, net, sched, x_in, generator=None,
                      continuous=False, clip_denoised=True,
                      noise_stream=None):
        """Full reverse chain from the condition image ``x_in`` (b,c,h,w).

        Returns the final image, or with ``continuous`` the process frames
        ((1+n_snap)*b, c, h, w): frame 0 is the condition, then every
        ``1 | (T//10)``-th step. ``noise_stream = (init, steps)`` of shapes
        (b,c,h,w) and (T,b,c,h,w) replaces every draw: steps[i] feeds loop
        position i (t = T-1-i), as in the JAX package."""
        if not self.conditional:
            raise NotImplementedError("unconditional sampling is not ported yet")
        T = sched.num_timesteps
        _, inter = _snapshot_count(T)
        condition_x = x_in.float()
        shape, device = tuple(x_in.shape), x_in.device
        if noise_stream is None:
            img = randn(shape, generator, device)
            step_noises = None
        else:
            img = torch.as_tensor(noise_stream[0], dtype=torch.float32,
                                  device=device)
            step_noises = torch.as_tensor(noise_stream[1], dtype=torch.float32,
                                          device=device)
        frames = [condition_x]
        for i, t in enumerate(range(T - 1, -1, -1)):
            noise = None if step_noises is None else step_noises[i]
            img = self.p_sample_step(net, sched, img, t, condition_x,
                                     clip_denoised, noise=noise,
                                     generator=generator)
            if continuous and t % inter == 0:
                frames.append(img)
        return torch.cat(frames, 0) if continuous else img

    def super_resolution(self, net, sched, x_sr, generator=None,
                         continuous=False):
        """Conditional SR from the bicubic-upsampled LR image."""
        return self.p_sample_loop(net, sched, x_sr, generator, continuous)
