"""The readings that a cell's limits are set from, in one process.

  python -m portbench.calibrate --workload <name> --seeds 12 --control 3 \
      --faults 3 [--seconds 1] [--first-seed N] [--trace-seed N]

Runs the cell's driver with a short window on the program for ``--seeds``
seeds (the lower readings), on the control (the reference in the
program's place at float8, the precision below the configuration's bf16)
for ``--control`` seeds, and with each fault of ``portbench/faults.py``
planted for ``--faults`` seeds (the upper readings); with
``--trace-seed`` also one traced run, whose summary and per-layer
readings it prints. Prints one JSON object: every number of every run,
and for each number the largest program reading and the smallest
control and fault readings. Needs no limits. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    p.add_argument("--trace-seed", type=int, default=None)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    from portbench import cells, faults
    from portbench.kinds import driver, release
    from portbench.run import _cache_dirs

    _cache_dirs(cells.ROOT)
    entry = cells.cell(cells.benchmark(), args.workload)[0]
    opt = cells.config(entry["config"])["opt"]
    traffic = cells.traffic(entry["traffic"])
    kind = traffic["kind"]
    drv = driver(kind)
    control = functools.partial(
        drv.ReferenceServing if kind == "sample" else drv.ReferenceTraining,
        precision="float8")
    out = {"workload": args.workload, "runs": []}

    def one(label, seed, system=None, trace=False):
        t = time.time()
        run = drv.run(opt, traffic, seed, args.seconds, trace, args.device,
                      time.time(), system)
        rec = {"side": label, "seed": seed, "numbers": run.numbers,
               "e2e": run.e2e, "steps": run.attempted, "detail": run.detail,
               "memory_peak_bytes": run.memory_peak_bytes,
               "seconds": time.time() - t}
        if trace:
            from portbench.run import result_line

            import torch
            bench = cells.benchmark()
            cell = cells.cell(bench, args.workload)
            info = {"kind": torch.cuda.get_device_name(0)}
            line = result_line(cell, run, True, {}, True, info, cell[2])
            rec["trace"] = {"metrics": line["metrics"],
                            "device": line["device"],
                            "breakdown": line["breakdown"]}
        out["runs"].append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        del run
        release(args.device)

    seed = args.first_seed
    for i in range(args.seeds):
        one("program", seed + i)
    for i in range(args.control):
        one("control", seed + 100 + i, control)
    for name, plant in faults.FAULTS[kind].items():
        for i in range(args.faults):
            with plant():
                one(f"fault.{name}", seed + 200 + i)
    if args.trace_seed is not None:
        one("traced", args.trace_seed, trace=True)

    sides = {}
    for r in out["runs"]:
        for k, v in r["numbers"].items():
            sides.setdefault(r["side"], {}).setdefault(k, []).append(v)
    out["lower"] = {k: max(v) for k, v in sides.get("program", {}).items()}
    out["upper"] = {side: {k: min(v) for k, v in d.items()}
                    for side, d in sides.items() if side != "program"}
    print(json.dumps(out, default=lambda x: None if not math.isfinite(x)
                     else x))


if __name__ == "__main__":
    main()
