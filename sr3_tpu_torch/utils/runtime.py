"""Device and dtype resolution shared by the port's entry points.

Counterpart of ``sr3_tpu/utils/runtime.py`` (platform selection) and of
``resolve_dtype`` in ``sr3_tpu/models/networks.py``:

- the device is CUDA by default; ``SR3_PLATFORM=cpu`` selects the CPU
  explicitly. Without a CUDA device and without ``SR3_PLATFORM=cpu`` the
  port raises: it never falls back to the CPU silently.
- compute dtype: bfloat16 on the accelerator (parameters stay float32),
  float32 on the CPU; a config's ``model.dtype`` overrides.
- on CUDA, float32 matmuls and convolutions run in full float32 (TF32 off),
  so a float32 run is comparable with the CPU and the JAX package.
"""

from __future__ import annotations

import os

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(platform=None):
    """torch.device for ``platform`` (default: $SR3_PLATFORM, else cuda)."""
    platform = (platform or os.environ.get("SR3_PLATFORM") or "cuda").lower()
    if platform not in _PLATFORMS:
        raise ValueError(f"SR3_PLATFORM must be one of {sorted(_PLATFORMS)}, "
                         f"got {platform!r}")
    if _PLATFORMS[platform] == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set SR3_PLATFORM=cpu to run the "
            "port on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def resolve_dtype(name=None, device=None):
    """Compute dtype: ``name`` if given, else bf16 on CUDA and f32 on CPU."""
    if name:
        return DTYPES[name]
    device = torch.device(device) if device is not None else resolve_device()
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def card_name_and_power():
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where nvidia-smi is missing or fails."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
