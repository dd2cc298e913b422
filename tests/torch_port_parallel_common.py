"""Shared pieces of the port's parallel tests: the tiny sr3 config, the
numpy dropout-mask feed, ``torchrun`` (N ranks of a Python command through
``torch.distributed.run --standalone``), and ``run_ranks``, which starts
the ranks of ``tests/torch_port_parallel_worker.py`` over gloo on the CPU
and returns what each rank saved.

The tiny model: inner_channel 8, 4 groups, two levels (mults [1, 2]),
attention at 8x8, image 16, T = 8.
"""

import copy
import os
import signal
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 8
SCHED = {"schedule": "linear", "n_timestep": T, "linear_start": 1e-6,
         "linear_end": 1e-2}
UNET = {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
        "norm_groups": 4, "channel_multiplier": [1, 2], "attn_res": [8],
        "res_blocks": 1, "dropout": 0.2}


def tiny_opt(phase="train", parallel=None, resume=None, ckpt=None,
             use_ema=False, batch=4, **unet):
    return {
        "name": "tiny", "phase": phase, "seed": 0, "parallel": parallel,
        "path": {"resume_state": resume, "checkpoint": ckpt},
        "datasets": {"train": {"batch_size": batch}},
        "model": {
            "which_model_G": "sr3", "dtype": "float32",
            "finetune_norm": False, "unet": dict(UNET, **unet),
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4},
                  "ema_scheduler": {"use_ema": use_ema, "ema_decay": 0.9,
                                    "step_start_ema": 0}},
    }


def unet_kwargs(opt):
    """UNet(...) arguments of a tiny config (float32)."""
    u = opt["model"]["unet"]
    return dict(in_channel=u["in_channel"], out_channel=u["out_channel"],
                inner_channel=u["inner_channel"], norm_groups=u["norm_groups"],
                channel_mults=tuple(u["channel_multiplier"]),
                attn_res=tuple(u["attn_res"]), res_blocks=u["res_blocks"],
                dropout=u["dropout"],
                image_size=opt["model"]["diffusion"]["image_size"],
                remat=bool(u.get("remat")))


class MaskFeed:
    """Numpy dropout masks (NHWC) handed to the port's ``dropout_mask`` in
    call order and recorded, to replay them elsewhere."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def port_mask(self, x, keep, generator=None):
        b, c, h, w = x.shape
        m = self.rng.random((b, h, w, c)) < keep
        self.drawn.append(m)
        return torch.from_numpy(m).permute(0, 3, 1, 2)


def torchrun(args, nprocs, env=None, timeout=240, cwd=None):
    """Run ``python <args>`` on ``nprocs`` local ranks through
    ``torch.distributed.run --standalone`` (which stops the other ranks
    when one fails); returns (exit code, the ranks' output). The whole
    process group is killed when ``timeout`` seconds pass."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nprocs}", *args]
    proc = subprocess.Popen(cmd, env=dict(os.environ, **(env or {})),
                            cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"ranks still running after {timeout} s:\n"
                             f"{out[-3000:]}")
    return proc.returncode, out


def run_ranks(tmp, nprocs, spec, timeout=240):
    """Run the worker's ``spec["cases"]`` on ``nprocs`` gloo ranks; returns
    each rank's {case: result}, in rank order."""
    os.makedirs(tmp, exist_ok=True)
    spec_path = os.path.join(tmp, "spec.pt")
    torch.save(copy.deepcopy(spec), spec_path)
    env = {"SR3_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    rc, out = torchrun(["-m", "tests.torch_port_parallel_worker", spec_path,
                        tmp], nprocs, env=env, timeout=timeout, cwd=ROOT)
    if rc:
        raise AssertionError(f"ranks failed (rc {rc}):\n{out[-6000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def assert_leaves_close(got, ref, rel):
    """Every leaf of ``got`` within ``rel`` of its reference's max|.|."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    for name, r in ref.items():
        tol = rel * max(np.abs(r).max(), 1e-30)
        np.testing.assert_allclose(got[name], r, rtol=0, atol=tol,
                                   err_msg=name)
