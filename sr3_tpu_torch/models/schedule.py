"""Noise-schedule math for Gaussian diffusion.

Counterpart of ``sr3_tpu/models/schedule.py``: every coefficient is computed
on the host in float64 numpy and cast to float32 (the reference's numpy-f64
to torch-f32 pipeline), then placed on the device as one tensor per buffer,
under the reference's buffer names, plus ``sqrt_alphas_cumprod_prev`` of
length T+1 (index 0 is gamma = 1), ``log_betas`` and ``timestep_map``.

A schedule option ``timestep_respacing`` (guided-diffusion's
``--timestep_respacing``, e.g. "250") keeps the steps ``space_timesteps``
picks from the ``n_timestep`` betas and makes the betas of the kept steps,
1 - abar_k / abar_prev, with their own tables, as guided-diffusion's
``SpacedDiffusion``; ``timestep_map[k]`` is the original timestep of kept
step k (``arange(T)`` without respacing), which a network conditioned on
the integer timestep takes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BUFFER_NAMES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2",
    "sqrt_alphas_cumprod_prev",
)


def _warmup_beta(linear_start, linear_end, n_timestep, warmup_frac):
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(
        linear_start, linear_end, warmup_time, dtype=np.float64)
    return betas


def make_beta_schedule(schedule, n_timestep, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3):
    """The seven beta schedules of the reference, float64 numpy."""
    if schedule == "quad":
        betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                            n_timestep, dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep,
                            dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                     + cosine_s)
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], a_min=None, a_max=0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Diffusion coefficients as float32 tensors on one device; length T
    except ``sqrt_alphas_cumprod_prev`` (T+1)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    log_betas: torch.Tensor
    timestep_map: torch.Tensor  # int64: the original timestep of each step
    num_timesteps: int


def space_timesteps(num_timesteps, section_counts):
    """The sorted timesteps of ``num_timesteps`` that guided-diffusion's
    ``space_timesteps`` keeps: ``section_counts`` is "N" or "N1,N2,..."
    (equal sections, each spaced evenly with rounded fractional strides,
    the stride added up as there)."""
    counts = [int(x) for x in section_counts.split(",")]
    size_per, extra = divmod(num_timesteps, len(counts))
    start, steps = 0, []
    for i, count in enumerate(counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide a section of {size} steps into "
                             f"{count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            steps.append(start + round(cur))
            cur += stride
        start += size
    return sorted(set(steps))


def make_schedule(schedule_opt, device="cpu") -> Schedule:
    """Schedule on ``device`` for a config dict with schedule / n_timestep /
    linear_start / linear_end (/ cosine_s, / timestep_respacing)."""
    betas = make_beta_schedule(
        schedule=schedule_opt["schedule"],
        n_timestep=int(schedule_opt["n_timestep"]),
        linear_start=schedule_opt.get("linear_start", 1e-4),
        linear_end=schedule_opt.get("linear_end", 2e-2),
        cosine_s=schedule_opt.get("cosine_s", 8e-3),
    )
    kept = np.arange(betas.shape[0])
    respacing = schedule_opt.get("timestep_respacing")
    if respacing:
        kept = np.asarray(space_timesteps(betas.shape[0], str(respacing)))
        cum = np.cumprod(1.0 - betas, axis=0)[kept]
        betas = 1.0 - cum / np.append(1.0, cum[:-1])
    alphas = 1.0 - betas
    cum = np.cumprod(alphas, axis=0)
    cum_prev = np.append(1.0, cum[:-1])
    post_var = betas * (1.0 - cum_prev) / (1.0 - cum)
    arrays = {
        "betas": betas,
        "alphas_cumprod": cum,
        "alphas_cumprod_prev": cum_prev,
        "sqrt_alphas_cumprod": np.sqrt(cum),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - cum),
        "log_one_minus_alphas_cumprod": np.log(1.0 - cum),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / cum),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / cum - 1),
        "posterior_variance": post_var,
        "posterior_log_variance_clipped": np.log(np.maximum(post_var, 1e-20)),
        "posterior_mean_coef1": betas * np.sqrt(cum_prev) / (1.0 - cum),
        "posterior_mean_coef2": (1.0 - cum_prev) * np.sqrt(alphas)
        / (1.0 - cum),
        "sqrt_alphas_cumprod_prev": np.sqrt(np.append(1.0, cum)),
        "log_betas": np.log(betas),
    }
    return Schedule(
        **{k: torch.from_numpy(v.astype(np.float32)).to(device)
           for k, v in arrays.items()},
        timestep_map=torch.from_numpy(kept.astype(np.int64)).to(device),
        num_timesteps=int(betas.shape[0]),
    )
