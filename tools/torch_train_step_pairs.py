#!/usr/bin/env python3
"""Time the PyTorch port's SR3 16->128 train step in two source trees, in
alternating pairs of fresh processes on one CUDA card.

  python3 tools/torch_train_step_pairs.py --pairs 4 PARENT_TREE CHANGE_TREE

Each tree is a checkout of the repository (for example a ``git archive`` of
the parent commit unpacked into an ignored directory). Every run is a new
process that imports that tree's ``sr3_tpu_torch`` and ``chip_smoke.py``,
builds the train-phase Trainer of ``configs/sr_sr3_16_128.json`` (batch 4,
bf16, seeded random weights), takes 3 warm-up steps on one seeded synthetic
batch, then times ``--steps`` steps with CUDA events and profiles 2 more
(device busy ms per step). Pair i runs the trees in the order A, B when i is
even and B, A when it is odd, so neither tree always runs first. The step is
host-bound, and processes spread more than a small change moves it: the
summary gives each run's median and each pair's difference, B - A.

  python3 tools/torch_train_step_pairs.py --one TREE   # one run, in-process

With ``--loop`` each run times the tree's ``train_loop`` instead: 3 warm-up
steps, then 3 windows of ``--steps`` steps over 8 seeded synthetic host
batches (a new host batch each step, as a loader feeds them; no log line,
validation or checkpoint), the wall time of each window after a
synchronize; the run's median is that of the windows' ms per step. It
holds the loop's batch path (the host copy, or ``device_prefetch`` where
the tree has it) against another tree's.
"""

import argparse
import os
import re
import subprocess
import sys


def one_loop(tree, steps):
    """Time ``train_loop`` of ``tree`` over host batches (``--loop``)."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import time

    import numpy as np
    import torch

    import chip_smoke as cs
    from sr3_tpu_torch.training.loops import train_loop

    if not os.path.abspath(cs.__file__).startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not the tree's")
    cs.device_phase(torch)
    trainer, opt = cs._train_trainer(torch, cs.CONFIG, 1)
    opt["train"]["print_freq"] = 10 ** 9
    b = opt["datasets"]["train"]["batch_size"]
    batches = cs._synthetic_batches(np, 8, b, seed=7)

    def run(n):
        trainer.begin_step = trainer.step
        opt["train"]["n_iter"] = trainer.step + n
        train_loop(trainer, batches, opt, lambda s, e: None)

    run(3)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0) / steps)
    print(f"RESULT tree={tree} batch={b} loop median_ms={np.median(ms):.3f} "
          f"min_ms={min(ms):.3f} max_ms={max(ms):.3f}", flush=True)


def one(tree, steps):
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not os.path.abspath(cs.__file__).startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not the tree's")
    cs.device_phase(torch)
    trainer, opt = cs._train_trainer(torch, cs.CONFIG, 1)
    b = opt["datasets"]["train"]["batch_size"]
    trainer.feed_data(cs._synthetic_batches(np, 1, b, seed=7)[0])
    for _ in range(3):
        trainer.optimize_parameters()
    torch.cuda.synchronize()
    ms = cs._time_each(torch, trainer.optimize_parameters, steps)
    print(f"RESULT tree={tree} batch={b} median_ms={np.median(ms):.3f} "
          f"min_ms={min(ms):.3f} max_ms={max(ms):.3f}", flush=True)
    cs._profile_steps(torch, trainer.optimize_parameters, 2)


def pairs(trees, n, steps, timeout, loop=False):
    import statistics

    medians = {t: [] for t in trees}
    diffs = []
    for i in range(n):
        order = trees if i % 2 == 0 else trees[::-1]
        got = {}
        for tree in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tree,
                 "--steps", str(steps)] + (["--loop"] if loop else []),
                capture_output=True, text=True, timeout=timeout)
            out = proc.stdout + proc.stderr
            m = re.search(r"RESULT .*median_ms=([\d.]+)", out)
            busy = re.search(r"device busy ([\d.]+) ms/step", out)
            if proc.returncode or not m:
                print(out[-4000:], flush=True)
                raise RuntimeError(f"run of {tree} failed ({proc.returncode})")
            got[tree] = float(m.group(1))
            medians[tree].append(got[tree])
            print(f"pair {i} {tree}: median {m.group(1)} ms, device busy "
                  f"{busy.group(1) if busy else 'not measured'} ms/step",
                  flush=True)
        diffs.append(got[trees[1]] - got[trees[0]])
    for tree in trees:
        print(f"{tree}: medians {medians[tree]}, median of medians "
              f"{statistics.median(medians[tree]):.3f} ms", flush=True)
    print(f"B - A per pair (ms): {[round(d, 3) for d in diffs]}; "
          f"median {statistics.median(diffs):.3f}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*", help="tree A, tree B")
    p.add_argument("--one", metavar="TREE", help="time one tree in-process")
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--timeout", type=float, default=300)
    p.add_argument("--loop", action="store_true",
                   help="time train_loop over host batches")
    a = p.parse_args()
    if a.one:
        (one_loop if a.loop else one)(a.one, a.steps)
    elif len(a.trees) == 2:
        pairs(a.trees, a.pairs, a.steps, a.timeout, a.loop)
    else:
        p.error("give two trees, or --one TREE")


if __name__ == "__main__":
    main()
