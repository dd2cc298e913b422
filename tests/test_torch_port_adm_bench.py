"""The benchmark's ADM serving kind (``portbench/kinds/adm_sample.py``)
on the CPU, at the tiny width of ``torch_port_adm_tiny``: a sound run of
the port is correct under the cell's limits; each serving fault planted
under ``p_sample_step`` and the control (the reference at float8 in the
program's place) are not; a traced run reports its breakdown, the FLOPs a
step and the K1 sites; and the cell's entries keep the benchmark's
contract."""

import functools
import time

import pytest

from portbench import cells, checks, faults
from portbench.kinds import adm_sample
from torch_port_adm_tiny import CELL, TRAFFIC, tiny_opt


def _run(seed=2 ** 32 + 7, system=None, trace=False):
    run = adm_sample.run(tiny_opt(), TRAFFIC, seed, 0.2, trace, "cpu",
                         time.time(), system)
    return run, checks.judge(run.numbers, cells.limits(CELL))


def test_a_sound_run_is_correct():
    run, (correct, judged) = _run()
    assert run.attempted >= 1 and correct, judged
    # float32 on both sides: rounding alone
    assert max(run.numbers.values()) < 1e-4, run.numbers
    assert set(run.e2e) == {"sample_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["sample"]))
def test_a_planted_fault_is_not_correct(fault):
    with faults.FAULTS["sample"][fault]():
        _, (correct, judged) = _run(seed=11)
    assert not correct, judged


def test_the_control_is_not_correct():
    control = functools.partial(adm_sample.ReferenceServing,
                                precision="float8")
    _, (correct, judged) = _run(seed=12, system=control)
    assert not correct, judged


def test_a_traced_run_reports_flops_and_k1_sites():
    run, _ = _run(seed=13, trace=True)
    s = run.summary
    assert set(s["trace"]["breakdown"]) == {"device_ops", "idle_gaps"}
    # the tiny network's 10 ResBlocks (3 down the input side with its
    # down block, 2 in the middle, 5 up with its up block): each
    # out_layers, the 8 non-resampling in_layers, and the head
    sites = s["k1_sites"]
    assert sum(x["post"] for x in sites) == 10 and len(sites) == 19
    assert s["flops_per_step"] > 0 and s["steps"] == run.attempted
    # no device on the CPU: no device metric is read
    for name in ("k1_roofline.sample", "mfu.sample",
                 "scale_shift_fused_pct.sample", "attention_pct.sample"):
        assert cells.reader(name)(dict(s, device_name="cpu")) is None


def test_the_cell_keeps_the_benchmarks_contract():
    bench = cells.benchmark()
    entry, e2e, layer = cells.cell(bench, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == \
        ("adm_128_512", "ancestral250_b8", 1)
    assert {m["name"] for m in e2e} == {"sample_images_per_s", "setup_s"}
    names = {m["name"] for m in layer}
    assert names == {"host_ms_per_step.sample", "kernels_per_step.sample",
                     "k1_roofline.sample", "mfu.sample",
                     "device_idle_pct.sample", "unet_device_ms.sample",
                     "chain_device_ms.sample", "scale_shift_fused_pct.sample",
                     "attention_pct.sample", "resample_pct.sample"}
    traffic = cells.traffic(entry["traffic"])
    assert traffic == dict(TRAFFIC, T=250, batch=8)
    assert set(cells.limits(CELL)) == {"eps_gap", "var_gap", "step_gap"}
    cfg = cells.config("adm_128_512")
    assert cfg["reduced"] == [] and cfg["opt"]["model"]["dtype"] == "bfloat16"
    for k in ("weights", "model.dtype", "labels", "datasets.val.batch_size",
              "model.unet.dropout"):
        assert k in cfg["assumed"]
