"""The harness finds each piece of a cell by name, rejects unknown names,
and takes a new piece without an edit to any file that is there."""

import json
import os

import pytest

from portbench import cells
from portbench.kinds import driver


def test_finds_every_piece_of_every_cell():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        entry, e2e, layer = cells.cell(bench, w["name"])
        assert cells.config(entry["config"])["opt"]["model"]
        kind = cells.traffic(entry["traffic"])["kind"]
        assert hasattr(driver(kind), "run")
        assert cells.limits(entry["name"])
        assert {m["name"] for m in e2e} >= {"setup_s"}
        for m in layer:
            assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("lookup, name", [
    (cells.config, "no_such_config"),
    (cells.traffic, "no_such_mix"),
    (cells.limits, "no_such.cell"),
    (cells.reader, "no_such_metric.sample"),
])
def test_unknown_names_are_refused(lookup, name):
    with pytest.raises(FileNotFoundError):
        lookup(name)


@pytest.mark.parametrize("name", ["../configs/x", "a b", "", "/abs", "x" * 65])
def test_malformed_names_are_refused(name):
    with pytest.raises(ValueError):
        cells.config(name)


def test_unknown_workload_and_kind_are_refused():
    with pytest.raises(KeyError):
        cells.cell(cells.benchmark(), "sr3_16_128.no_such_mix")
    with pytest.raises(ModuleNotFoundError):
        driver("no_such_kind")


def test_a_new_piece_is_added_as_a_file(tmp_path):
    base = str(tmp_path)
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(base, sub))
    with open(os.path.join(base, "configs", "new_cfg.json"), "w") as f:
        json.dump({"opt": {"model": {}}}, f)
    with open(os.path.join(base, "traffic", "new_mix.json"), "w") as f:
        json.dump({"kind": "sample", "batch": 2}, f)
    with open(os.path.join(base, "limits", "new_cfg.new_mix.json"), "w") as f:
        json.dump({"limits": {"eps_gap": 0.1}}, f)
    with open(os.path.join(base, "metrics", "new_metric.py"), "w") as f:
        f.write("def read(summary):\n    return summary.get('x')\n")
    bench = cells.benchmark()
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1})
    bench["per_layer"].append({"name": "new_metric.sample", "unit": "ms",
                               "moves": "sample_images_per_s"})
    bench["end_to_end"][0].setdefault("workloads", []).append(
        "new_cfg.new_mix")
    entry, e2e, layer = cells.cell(bench, "new_cfg.new_mix")
    assert "new_metric.sample" in [m["name"] for m in layer]
    assert "sample_images_per_s" in [m["name"] for m in e2e]
    assert cells.config("new_cfg", base)["opt"] == {"model": {}}
    assert cells.traffic("new_mix", base)["batch"] == 2
    assert cells.limits("new_cfg.new_mix", base) == {"eps_gap": 0.1}
    # found by its full name, and by the part before the first dot
    assert cells.reader("new_metric.sample", base)({"x": 3}) == 3
    assert cells.reader("new_metric.train", base)({"x": 4}) == 4


def test_a_full_name_reader_comes_before_the_shared_one(tmp_path):
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "m.py").write_text("def read(s):\n    return 1\n")
    (tmp_path / "metrics" / "m.train.py").write_text(
        "def read(s):\n    return 2\n")
    assert cells.reader("m.sample", str(tmp_path))({}) == 1
    assert cells.reader("m.train", str(tmp_path))({}) == 2
