"""The check fails what it must: each fault planted under the timed path,
and the control (the reference at float8 in the program's place), drive a
whole run of the tiny cell and read ``correct`` false under the real
cells' limits; a sound run reads true."""

import functools

import pytest

from portbench import faults
from portbench.kinds import driver
from portbench.run import execute
from portbench.tests import portbench_tiny as tiny

CPU = {"platform": "cpu", "kind": "cpu", "count": 1}
CELLS = [(tiny.SAMPLE, "sample"), (tiny.TRAIN, "train")]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("tiny"))
    return tiny.write(base), base


def _run(bench, cell, seed=123456789012, trace=False):
    b, base = bench
    return execute(b, cell, seed, 0.2, trace, "cpu", CPU, base)[:2]


@pytest.mark.parametrize("cell, kind", CELLS)
def test_a_sound_run_is_correct(bench, cell, kind):
    line, judged = _run(bench, cell)
    assert line["correct"], judged
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell, kind, fault", [
    (c, k, f) for c, k in CELLS for f in sorted(faults.FAULTS[k])])
def test_a_planted_fault_is_not_correct(bench, cell, kind, fault):
    with faults.FAULTS[kind][fault]():
        line, judged = _run(bench, cell)
    assert not line["correct"], judged


@pytest.mark.parametrize("cell, kind", CELLS)
def test_the_control_is_not_correct(bench, cell, kind, monkeypatch):
    drv = driver(kind)
    control = functools.partial(
        drv.ReferenceServing if kind == "sample" else drv.ReferenceTraining,
        precision="float8")
    orig = drv.run
    monkeypatch.setattr(drv, "run", lambda *a: orig(*a, system=control))
    line, judged = _run(bench, cell)
    assert not line["correct"], judged


@pytest.mark.parametrize("cell, kind", CELLS)
def test_a_traced_run_reports_its_breakdown(bench, cell, kind):
    line, _ = _run(bench, cell, trace=True)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    # no device on the CPU: no device metric is read
    names = set(line["metrics"])
    assert names <= {f"host_ms_per_step.{kind}"}, names
