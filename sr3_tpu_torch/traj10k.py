"""Train the port on configs/_traj100k.json to 10k steps on the card, then
score its samplers on the checkpoint.

  python -m sr3_tpu_torch.traj10k [--out DIR] [--precheck]

1. writes a copy of configs/_traj100k.json that changes only
   ``train.n_iter`` (10000) and ``train.save_checkpoint_freq`` (10000);
2. runs ``python -m sr3_tpu_torch.sr -p train -c <copy>`` (batch 8,
   device_data, steps_per_dispatch 100, EMA from step 1000, validation at
   T=200); past ``TRAIN_TIMEOUT`` seconds it sends SIGTERM, on which the
   training loop saves a checkpoint at the next step boundary;
3. copies the run's train.log / val.log into ``--out`` (default
   experiments/traj10k) and turns train.log into ``TORCH_TRAJ10K.json``
   with tools/traj_extract.py;
4. runs ``python -m sr3_tpu_torch.sampler_eval`` on the last checkpoint
   over the 6 fixture images (val ``data_len`` -1), eta 1, ``REPS`` chains
   an image, once for each entry of ``EVALS``: the serving network (bf16)
   at T=2000 with ddpm:2000 ddim:50 dpm++:50 into
   ``TORCH_SAMPLER_EVAL_10K.json``; the same in float32, and the ancestral
   chain at T=200 in both dtypes, into ``TORCH_SAMPLER_EVAL_10K_WITNESS.json``
   (one artifact a key).

``--precheck`` first runs the sampler tool on a random-weight checkpoint at
T=20 and stops before training if it fails. Checkpoints stay under
``experiments/``; only logs and JSON go to ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "_traj100k.json")
EXTRACT = os.path.join(ROOT, "tools", "traj_extract.py")
N_ITER = 10000
TRAIN_TIMEOUT = 2900  # seconds
REPS = 6
# (artifact key, model.dtype, val schedule length, samplers); the first is
# the record, the others its witnesses
EVALS = [
    ("bfloat16_T2000", "bfloat16", 2000, ["ddpm:2000", "ddim:50", "dpm++:50"]),
    ("float32_T2000", "float32", 2000, ["ddpm:2000", "ddim:50", "dpm++:50"]),
    ("bfloat16_T200", "bfloat16", 200, ["ddpm:200"]),
    ("float32_T200", "float32", 200, ["ddpm:200"]),
]


def run(cmd, log=None, timeout=None):
    """Run ``cmd`` from the repo root (output to ``log`` when given); past
    ``timeout`` seconds send SIGTERM, then wait for the process to end.
    Returns its exit code."""
    print("#", " ".join(cmd), flush=True)
    out = open(log, "w") if log else None
    try:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT if out else None)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            print(f"# {timeout} s: SIGTERM (checkpoint at the next step)",
                  flush=True)
            proc.send_signal(signal.SIGTERM)
            return proc.wait()
    finally:
        if out:
            out.close()


def write_config(path, changes):
    """CONFIG with ``changes`` ({"section.key": value}) at ``path``."""
    from sr3_tpu_torch.utils.config import load_json_with_comments

    opt = load_json_with_comments(CONFIG)
    for dotted, value in changes.items():
        *sections, key = dotted.split(".")
        node = opt
        for part in sections:
            node = node[part]
        node[key] = value
    with open(path, "w") as f:
        json.dump(opt, f, indent=1)
    return opt


def sampler_eval(cfg, resume, out, timesteps, samplers, reps):
    return run([sys.executable, "-m", "sr3_tpu_torch.sampler_eval",
                "--config", cfg, "--resume", resume,
                "--timesteps", str(timesteps), "--samplers", *samplers,
                "--eta", "1", "--reps", str(reps), "--out", out])


def precheck(out):
    """The sampler tool on a random-weight .pth of the config's model."""
    import torch

    from sr3_tpu_torch.models.networks import define_G

    cfg = os.path.join(out, "precheck.json")
    opt = write_config(cfg, {"datasets.val.data_len": 2})
    net = define_G(opt, device="cpu", seed=0).denoise_fn
    prefix = os.path.join(out, "precheck_I0_E0")
    torch.save(net.state_dict(), prefix + "_gen.pth")
    rc = sampler_eval(cfg, prefix, os.path.join(out, "precheck_eval.json"),
                      20, ["ddpm:20", "ddim:5"], 1)
    os.remove(prefix + "_gen.pth")
    return rc


def train(out):
    """Steps 1-3; returns (exit code, checkpoint prefix or None)."""
    cfg = os.path.join(out, "_traj10k.json")
    write_config(cfg, {"train.n_iter": N_ITER,
                       "train.save_checkpoint_freq": N_ITER})
    before = set(glob.glob(os.path.join(ROOT, "experiments", "*")))
    t0 = time.perf_counter()
    rc = run([sys.executable, "-m", "sr3_tpu_torch.sr", "-p", "train", "-c",
              cfg], log=os.path.join(out, "train_stdout.log"),
             timeout=TRAIN_TIMEOUT)
    seconds = round(time.perf_counter() - t0, 1)
    print(f"# training exit {rc} after {seconds} s", flush=True)
    (exp,) = set(glob.glob(os.path.join(ROOT, "experiments", "*"))) - before
    for name in ("train.log", "val.log"):
        shutil.copy(os.path.join(exp, "logs", name), out)
    record = os.path.join(out, "TORCH_TRAJ10K.json")
    run([sys.executable, EXTRACT, os.path.join(out, "train.log"), "--out",
         record])
    header = {
        "config": f"{os.path.relpath(CONFIG, ROOT)} with train.n_iter "
                  f"{N_ITER} and train.save_checkpoint_freq {N_ITER} "
                  f"(written at run time)",
        "script": "python -m sr3_tpu_torch.traj10k",
        "card": card(),
        "train_seconds": seconds,
        "note": "val at T=200 on the config's val images, EMA weights; the "
                "checkpoint was not kept"}
    with open(record) as f:
        traj = json.load(f)
    traj.pop("log", None)
    with open(record, "w") as f:
        json.dump({**header, **traj}, f, indent=1)
    ckpts = glob.glob(os.path.join(exp, "checkpoint", "I*_gen.pth"))
    if not ckpts:
        print("# no checkpoint", flush=True)
        return rc or 1, None
    last = max(ckpts,
               key=lambda p: int(os.path.basename(p)[1:].split("_")[0]))
    return rc, last[:-len("_gen.pth")]


def score(out, resume):
    """Step 4: every entry of EVALS on the checkpoint; returns the exit
    code."""
    print(f"# checkpoint {resume}", flush=True)
    witness = {}
    rc = 0
    for key, dtype, timesteps, samplers in EVALS:
        cfg = os.path.join(out, f"_traj10k_{key}.json")
        write_config(cfg, {"datasets.val.data_len": -1,
                           "model.dtype": dtype})
        path = os.path.join(out, f"eval_{key}.json")
        t0 = time.perf_counter()
        rc_eval = sampler_eval(cfg, resume, path, timesteps, samplers, REPS)
        print(f"# {key}: exit {rc_eval} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rc = rc or rc_eval
        if rc_eval == 0:
            with open(path) as f:
                art = json.load(f)
            art["config"] = (f"{os.path.relpath(CONFIG, ROOT)} with "
                             f"datasets.val.data_len -1 and model.dtype "
                             f"{dtype} (written at run time)")
            art["resume"] = "the 10k checkpoint (not kept)"
            witness[key] = art
    first = EVALS[0][0]
    head = {"script": "python -m sr3_tpu_torch.traj10k "
                      "(python -m sr3_tpu_torch.sampler_eval on the 10k "
                      "checkpoint, EMA weights, the 6 fixture images)",
            "card": card()}
    if first in witness:
        with open(os.path.join(out, "TORCH_SAMPLER_EVAL_10K.json"), "w") as f:
            json.dump({**head, **witness.pop(first)}, f, indent=1)
    with open(os.path.join(out, "TORCH_SAMPLER_EVAL_10K_WITNESS.json"),
              "w") as f:
        json.dump({**head, **witness}, f, indent=1)
    return rc


def card():
    from sr3_tpu_torch.utils.runtime import card_name_and_power

    return card_name_and_power()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "experiments",
                                                  "traj10k"))
    ap.add_argument("--precheck", action="store_true")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    print(f"# card: {card()}", flush=True)
    if args.precheck and precheck(out) != 0:
        print("# precheck failed: not training", flush=True)
        return 1
    rc, resume = train(out)
    if resume is None:
        return rc
    return rc or score(out, resume)


if __name__ == "__main__":
    sys.exit(main())
