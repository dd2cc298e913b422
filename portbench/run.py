"""Run one benchmark cell once and print its result line.

  python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload ``<config>.<traffic>``) is run by
the driver of its traffic's kind (``portbench/kinds``) on the program
under test, ``sr3_tpu_torch``: set-up (weights and inputs made from the
seed, warm-up), a window of ``--seconds``, then, with ``--trace 1``, the
host spans and the profiled steps that the per-layer metrics read. The
check against the reference runs once all that is done and the program
is freed. The last lines on standard error give each compared number
beside its limit; the last line on standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` the
``breakdown``, and last ``checks``.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is present, and 3 when the JAX package or JAX is loaded in the
process after the window.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def process_start():
    """This process's start on the wall clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "sr3_tpu")


class ForbiddenImport(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cache_dirs(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell, run, correct, checks, trace, device_info, layer):
    """The result's dict, its keys in the contract's order, ``checks``
    last."""
    if trace:
        metrics = {}
        summary = dict(run.summary, device_name=device_info["kind"])
        from portbench import cells

        for m in layer:
            value = cells.reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = run.summary["trace"]
        device_info = dict(device_info, busy_s=tr["busy_s"],
                           window_s=tr["window_s"])
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell[1]}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device_info}
    if trace:
        line["breakdown"] = run.summary["trace"]["breakdown"]
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    return line


def execute(bench, workload, seed, seconds, trace, device, device_info,
            base=None):
    """Everything of a run but the look for a card: the cell's driver, the
    check against its limits and the result line. Returns (line, judged
    numbers, the check's detail)."""
    from portbench import cells, checks
    from portbench.kinds import driver

    base = base or cells.HERE
    cell = cells.cell(bench, workload)
    entry = cell[0]
    opt = cells.config(entry["config"], base)["opt"]
    traffic = cells.traffic(entry["traffic"], base)
    limits = cells.limits(entry["name"], base)
    run = driver(traffic["kind"]).run(opt, traffic, seed, seconds, trace,
                                      device, T_START)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded in the run's process: {found}")
    correct, judged = checks.judge(run.numbers, limits)
    info = dict(device_info, memory_peak_bytes=run.memory_peak_bytes)
    return result_line(cell, run, correct, judged, trace, info,
                       cell[2]), judged, run.detail


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import cells

    _cache_dirs(cells.ROOT)
    bench = cells.benchmark()
    entry = cells.cell(bench, args.workload)[0]
    chips = int(entry["chips"])

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {entry['name']} needs {chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        line, judged, detail = execute(bench, args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       "cuda:0", info)
    except ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print("setup parts (s): " + json.dumps(detail.get("setup_parts")),
          file=sys.stderr)
    for k, v in judged.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
