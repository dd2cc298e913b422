"""Compare reverse-chain samplers on a trained checkpoint: the port's copy
of tools/sampler_eval.py (the same CLI, rows and artifact).

  python -m sr3_tpu_torch.sampler_eval --config configs/_traj100k.json \
      --resume experiments/traj100k_<ts>/checkpoint/I10000_E13334 \
      --timesteps 2000 --samplers ddpm:2000 ddim:50 dpm++:50 \
      --eta 1 --reps 6 --out sampler_eval.json

Scores PSNR and SSIM (and the wall-clock cost) of each sampler on the
config's val set with the val schedule (``--timesteps`` overrides its
length). Each ``--samplers`` entry is ``<name>:<steps>``; ``ddpm`` ignores
the steps (the ancestral chain runs the whole schedule), the others need
them. ``--eta`` applies to ddim and dpm++ (1 = stochastic). ``--reps N``
runs N noise chains per image per sampler.

The weights are the ``_gen.pth`` of the ``--resume`` prefix, or the EMA
weights of its ``_opt.pth`` when the config turns EMA on
(``Trainer.load_network``). Rep k of image i draws from its own generator,
seeded from (seed, i, k) through ``fold_seed``, so every sampler draws the
same noise for it and the rep-wise deltas against the first sampler listed
are paired comparisons. The images of one rep run as one group through
``Trainer.test_batched``; the draws do not depend on the grouping. The
device is CUDA; ``SR3_PLATFORM=cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

import sr3_tpu_torch.utils.metrics as Metrics
from sr3_tpu_torch.data.loader import create_dataset
from sr3_tpu_torch.training.evaluation import fold_seed, per_image
from sr3_tpu_torch.training.trainer import Trainer
from sr3_tpu_torch.utils.config import load_config


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", required=True,
                    help="checkpoint prefix (no _gen/_opt suffix)")
    ap.add_argument("--timesteps", type=int, default=None,
                    help="override val schedule length")
    ap.add_argument("--samplers", nargs="+", default=["ddpm:200", "ddim:50",
                                                      "dpm++:25"])
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--reps", type=int, default=1,
                    help="noise chains per image per sampler (paired "
                         "across samplers, see the docstring)")
    ap.add_argument("--out", default=None, help="optional JSON artifact path")
    args = ap.parse_args(argv)
    specs = []
    for spec in args.samplers:
        name, _, steps = spec.partition(":")
        if name != "ddpm" and not steps:
            # without an explicit count nfe would be recorded as 0
            ap.error(f"sampler spec '{spec}' needs an explicit :steps")
        specs.append((spec, name, int(steps or 0)))
    return args, specs


def score_grid(trainer, items, reps, seed):
    """(psnr, ssim, seconds): [image][rep] grids of the configured
    sampler's outputs against the items' HR images, and the seconds spent
    in the chains."""
    xs = np.stack([it["SR"] for it in items])
    hrs = [Metrics.tensor2img(it["HR"]) for it in items]
    psnr = [[] for _ in items]
    ssim = [[] for _ in items]
    secs = 0.0
    for k in range(reps):
        gens = [torch.Generator(device=trainer.device).manual_seed(
                    fold_seed(fold_seed(seed, i), k))
                for i in range(len(items))]
        t0 = time.perf_counter()
        out = trainer.test_batched(xs, gens)  # host numpy: synchronized
        secs += time.perf_counter() - t0
        for i, hr in enumerate(hrs):
            sr = Metrics.tensor2img(out[i])
            psnr[i].append(Metrics.calculate_psnr(sr, hr))
            ssim[i].append(Metrics.calculate_ssim(sr, hr))
    return psnr, ssim, secs


def summarize(spec, eta, nfe, reps, psnrs, ssims, secs, first=None):
    """One result row (the JAX tool's keys); with ``first`` (the first
    sampler's row) the paired deltas against it."""
    flat_p = [p for per_img in psnrs for p in per_img]
    flat_s = [s for per_img in ssims for s in per_img]
    n = len(flat_p)
    row = {
        "sampler": spec,
        "eta": eta,
        "nfe": nfe,
        "reps": reps,
        "psnr_db": [[round(p, 2) for p in per_img] for per_img in psnrs],
        "ssim": [[round(s, 4) for s in per_img] for per_img in ssims],
        "avg_psnr_db": round(float(np.mean(flat_p)), 3),
        "se_psnr_db": round(float(np.std(flat_p) / np.sqrt(n)), 3),
        "avg_ssim": round(float(np.mean(flat_s)), 4),
        "se_ssim": round(float(np.std(flat_s) / np.sqrt(n)), 4),
        "sample_seconds_total": round(secs, 1),
    }
    if first is not None:
        dp = np.asarray(row["psnr_db"]) - np.asarray(first["psnr_db"])
        ds = np.asarray(row["ssim"]) - np.asarray(first["ssim"])
        row["d_psnr_vs_first"] = round(float(dp.mean()), 3)
        row["d_psnr_se"] = round(float(dp.std() / np.sqrt(dp.size)), 3)
        row["d_ssim_vs_first"] = round(float(ds.mean()), 4)
        row["d_ssim_se"] = round(float(ds.std() / np.sqrt(ds.size)), 4)
        # chains of one image share that image, so the flat SE overstates
        # the effective n; the cluster-robust SE takes each image's mean
        # delta first (ddof=1 across images)
        if dp.shape[0] > 1:
            pi, si = dp.mean(axis=1), ds.mean(axis=1)
            n_img = dp.shape[0]
            row["d_psnr_se_cluster"] = round(
                float(pi.std(ddof=1) / np.sqrt(n_img)), 3)
            row["d_ssim_se_cluster"] = round(
                float(si.std(ddof=1) / np.sqrt(n_img)), 4)
    return row


def main(argv=None):
    args, specs = parse_args(argv)
    opt = load_config(args.config)
    opt["phase"] = "val"
    opt["path"]["resume_state"] = args.resume
    sched_opt = dict(opt["model"]["beta_schedule"]["val"])
    if args.timesteps:
        sched_opt["n_timestep"] = args.timesteps
    items = list(per_image(create_dataset(opt["datasets"]["val"], "val")))

    trainer = Trainer(opt)
    trainer.set_new_noise_schedule(sched_opt, "val")
    seed = opt.get("seed", 0) or 0
    results = []
    for spec, name, steps in specs:
        sopt = copy.deepcopy(opt)  # no settings leak between samplers
        diff = sopt["model"]["diffusion"]
        diff["sampler"] = name
        if name != "ddpm":
            diff["sampler_steps"] = steps
        diff["eta"] = args.eta
        trainer.opt = sopt  # Trainer._chain_fn reads the sampler from it
        psnrs, ssims, secs = score_grid(trainer, items, args.reps, seed)
        nfe = steps if name != "ddpm" else sched_opt["n_timestep"]
        row = summarize(spec, args.eta, nfe, args.reps, psnrs, ssims, secs,
                        results[0] if results else None)
        results.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "config": args.config, "resume": args.resume,
                "val_timesteps": sched_opt["n_timestep"],
                "results": results,
            }, f, indent=1)
        print(f"# wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
