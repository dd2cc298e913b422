"""Device ms per call of K4 (``csrc/attention.cu``: the flash-attention
forward with its logsumexp, bf16) in a given checkout, read with this
checkout's chip_smoke.py (``_device_ms``: 20 calls queued behind a spin
kernel, CUDA events around them), at the shapes of PERF.md section 6,
beside the one PyTorch call that computes the same function
(``scaled_dot_product_attention``, timed the same way; the port never calls
it) and the least time the card could take (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, the larger); with --steps N also the median
CUDA-event ms of N batch-8 serving steps (``p_sample_step`` of the bf16
sampling copy, T=2000 schedule) of sr_sr3_64_512_attn (512^2) and of
sr_sr3_16_128, both before any profiler in the process. On one NVIDIA GPU;
imports nothing of JAX.

  python sr3_tpu_torch/k4_device_ms.py [TREE] [--steps N]
  python sr3_tpu_torch/k4_device_ms.py --order ABBA [--steps N] TREE_A TREE_B

TREE is the root of a checkout of this repository (default: this one);
its sr3_tpu_torch is imported and its kernels built under
TREE/sr3_tpu_torch/_build. To compare two commits by one yardstick, unpack
both with ``git archive`` into a directory that .gitignore lists and give
--order: one fresh process a letter, in that order (ABBA: parent, change,
change, parent), then the median of each tree's runs a shape. One run
prints the card's name and power limit, a line a shape, and last one JSON
object {shape: {"ms", "sdpa_ms", "bound_ms", "bound_by"}, "steps": {...}}.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (bh, seq, head_dim) of PERF.md section 6's K4 rows, each with its lse
SHAPES = [(8, 4096, 512), (2, 4096, 512), (1, 16384, 256), (2, 1024, 512),
          (8, 1024, 512), (8, 256, 512), (8, 256, 128), (8, 64, 512),
          (8, 16, 256)]
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bound(bh, seq, d):
    """(ms, "operations" | "bytes"): two (seq x seq x d) products; q, k, v
    read once in bf16, o and lse written once in float32."""
    ops = 4 * bh * seq * seq * d / PEAK_BF16_FLOPS
    nbytes = (3 * 2 * bh * seq * d + 4 * bh * seq * d + 4 * bh * seq) \
        / PEAK_BYTES
    return 1000 * max(ops, nbytes), "operations" if ops > nbytes else "bytes"


def _steps(torch, cs, n):
    """Median CUDA-event ms of n batch-8 serving steps at 512^2 and at
    16->128, each trainer freed before the next."""
    out = {}
    for key, config in (("serving_512_b8", cs.CONFIG_512),
                        ("serving_16_128_b8", cs.CONFIG)):
        trainer = cs._serving_trainer(config)
        with torch.inference_mode():
            step = (_step_512(torch, trainer) if config == cs.CONFIG_512
                    else cs._serving_step(torch, trainer, 3))
            ms = cs._time_each(torch, step, n)
        out[key] = {"median_ms": statistics.median(ms), "min_ms": min(ms),
                    "max_ms": max(ms), "steps": n}
        print(f"  {key}: median {out[key]['median_ms']:.3f} ms of {n} "
              f"(min {min(ms):.3f}, max {max(ms):.3f})", flush=True)
        del trainer, step
        torch.cuda.empty_cache()
    return out


def _step_512(torch, trainer):
    from sr3_tpu_torch.models.schedule import make_schedule

    g = torch.Generator(device="cuda").manual_seed(17)
    sched = make_schedule(dict(schedule="linear", n_timestep=2000,
                               linear_start=1e-6, linear_end=1e-2), "cuda")
    net, diff = trainer._eval_params(), trainer.diffusion
    cond = torch.rand(8, 3, 512, 512, device="cuda", generator=g) * 2 - 1
    img = torch.randn(8, 3, 512, 512, device="cuda", generator=g)
    ts = iter(range(1999, -1, -1))
    return lambda: diff.p_sample_step(net, sched, img, next(ts), cond,
                                      generator=g)


def main(tree, steps):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from sr3_tpu_torch.ops import attention

    if not attention.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"imported {attention.__file__}, not {tree}'s")
    cs = _chip_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"port of {tree}", flush=True)
    out = {}
    if steps:  # first: before anything else has run in the process
        out["steps"] = _steps(torch, cs, steps)
    g = torch.Generator(device="cuda").manual_seed(12)
    for bh, seq, d in SHAPES:
        q, k, v = (torch.randn(bh, seq, d, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        o, lse = attention.attention_fwd(q, k, v, scale)
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"K4 {bh}x{seq}x{d}: non-finite output")
        q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
        ms = cs._device_ms(torch, lambda: attention.attention_fwd(
            q, k, v, scale), required=True)
        sdpa = cs._device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=scale))
        b_ms, by = bound(bh, seq, d)
        label = f"{bh}x{seq}x{d}"
        out[label] = {"ms": ms, "sdpa_ms": sdpa, "bound_ms": b_ms,
                      "bound_by": by}
        print(f"  K4 {label} with lse: {ms:.4f} ms, SDPA "
              f"{cs._show(sdpa)} ms, bound {b_ms:.4f} ms ({by}; "
              f"{b_ms / ms:.1%} of it)", flush=True)
        del q, k, v, q4, k4, v4, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def ordered(trees, order, steps, timeout):
    """One fresh process a letter of ``order`` (A: trees[0], B:
    trees[1]); prints each tree's median a shape."""
    runs = {t: [] for t in trees}
    for letter in order:
        tree = trees["AB".index(letter)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--steps",
             str(steps)], capture_output=True, text=True, timeout=timeout)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], flush=True)
            raise RuntimeError(f"run of {tree} failed ({proc.returncode})")
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {}
    for tree in trees:
        res = runs[tree]
        keys = [k for k in res[0] if k != "steps"]
        summary[tree] = {k: statistics.median(r[k]["ms"] for r in res)
                         for k in keys}
        for key in res[0].get("steps", {}):
            summary[tree][key] = statistics.median(
                r["steps"][key]["median_ms"] for r in res)
        print(f"{tree} ({len(res)} runs), median ms: {summary[tree]}",
              flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT  # not this package's own directory
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*",
                   help="TREE, or TREE_A TREE_B with --order")
    p.add_argument("--steps", type=int, default=0,
                   help="also time N batch-8 serving steps, 512^2 and "
                   "16->128")
    p.add_argument("--order", default="",
                   help="A and B letters, a fresh process each (e.g. ABBA)")
    p.add_argument("--timeout", type=float, default=600)
    a = p.parse_args()
    if a.order:
        if len(a.trees) != 2 or set(a.order) - set("AB"):
            p.error("--order takes A / B letters and two trees")
        sys.exit(ordered(a.trees, a.order, a.steps, a.timeout))
    if len(a.trees) > 1:
        p.error("give one tree, or two with --order")
    sys.exit(main(a.trees[0] if a.trees else ROOT, a.steps))
