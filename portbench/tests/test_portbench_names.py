"""BENCHMARK.json keeps to the benchmark's contract: names, units, keys and
the files it names."""

import os
import re

import pytest

from portbench import cells

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
BENCH = cells.benchmark()
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p.split("/")
               and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    with open(os.path.join(cells.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_keys_names_and_units(group):
    entries = BENCH[group]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[group] - ({"workloads"} if "bound" in KEYS[group]
                                        or group == "per_layer" else set())
        assert not extra and KEYS[group] <= set(e), (e["name"], extra)
        assert NAME.fullmatch(e["name"]), e["name"]
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.fullmatch(e[k])
        for k in e.get("reduced", []):
            assert NAME.fullmatch(k)
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_cells_configs_and_metrics_fit_together():
    wl = {w["name"]: w for w in BENCH["workloads"]}
    cfg = {c["name"]: c for c in BENCH["configs"]}
    assert {w["config"] for w in wl.values()} == set(cfg)
    for c in cfg.values():
        assert c["file"].split("/")[0] in BENCH["paths"]
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
        assert cells.config(c["name"])["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in wl.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in wl.values()) <= max(1, len(wl) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for name in wl:
        _, reported, layer = cells.cell(BENCH, name)
        names = {m["name"] for m in reported}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names
