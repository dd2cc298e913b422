"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root lists the cells and metrics; a configuration is
``portbench/configs/<config>.json``, a traffic mix
``portbench/traffic/<traffic>.json``, a cell's limits
``portbench/limits/<workload>.json`` and a per-layer metric's reader
``portbench/metrics/<metric>.py``, or, where that file is absent, the
reader of the name's part before its first dot (``mfu.py`` reads
``mfu.train`` and ``mfu.sample``). Adding any of them edits no file that
is there."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name, what):
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def _json(path, what, name):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"), "benchmark",
                 "BENCHMARK.json")


def config(name, base=HERE):
    return _json(os.path.join(base, "configs",
                              _checked(name, "config") + ".json"),
                 "configuration", name)


def traffic(name, base=HERE):
    return _json(os.path.join(base, "traffic",
                              _checked(name, "traffic") + ".json"),
                 "traffic mix", name)


def limits(workload, base=HERE):
    return _json(os.path.join(base, "limits",
                              _checked(workload, "workload") + ".json"),
                 "limits of", workload)["limits"]


def reader(metric, base=HERE):
    """The ``read(summary)`` function of a per-layer metric."""
    _checked(metric, "metric")
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(base, "metrics", stem + ".py")
        if os.path.isfile(path):
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader of the metric {metric!r}")


def cell(bench, workload):
    """The workload's entry and the metrics it reports: (entry, end-to-end
    metrics, per-layer metrics)."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = found[0]

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in names]
    return entry, e2e, layer
