"""The port's program spans and counters (sr3_tpu_torch/utils/profiler.py)
where the work happens, on the CPU with a tiny UNet.

- With no profiler ``span()`` is one shared no-op object and a train step
  records nothing.
- Under ``torch.profiler`` a resident train step records ``trainer.step``
  holding ``trainer.forward``, ``trainer.backward`` and
  ``trainer.optimizer``; the kernel backwards of K1 and K2
  (``ops.kernel_backward``) sit under the backward; a chain step of every
  sampler records ``chain.step`` holding ``chain.eps`` with its ``t``; a
  span opened on another thread hangs under the newest open span.
- Every span's host interval lies inside the profiler's own event around
  the call, on the profiler's clock, and ``trace`` writes the spans into its
  trace file on that clock.
- ``block.fused`` / ``block.split`` count the Blocks by the route that
  dropout and train / eval mode give them; the kernel counters keep their
  names and ``.n``.
"""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sr3_tpu_torch.models import unet
from sr3_tpu_torch.ops import attention, conv_fused, groupnorm
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils import profiler

from test_torch_port_driver import _config

PHASES = {"trainer.forward", "trainer.backward", "trainer.optimizer"}


@pytest.fixture(autouse=True)
def _clean():
    profiler.reset_spans()
    yield
    profiler.reset_spans()


def _trainer(dropout=0.1, phase="train"):
    opt = _config()
    opt["phase"] = phase
    opt["seed"] = 5
    opt["model"]["diffusion"]["image_size"] = 16
    opt["model"]["unet"]["dropout"] = dropout
    t = create_model(opt, device="cpu")
    t.set_new_noise_schedule(opt["model"]["beta_schedule"][phase], phase)
    return t


class _Decoded(list):
    def _decoded(self, i):
        return self[i]


@pytest.fixture(scope="module")
def trainer():
    torch.manual_seed(0)
    t = _trainer()
    rng = np.random.default_rng(0)
    t.load_device_dataset(_Decoded(
        [{k: rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
          for k in ("HR", "SR")} for _ in range(4)]))
    return t


def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler`` inside a
    ``record_function("call")``; returns that event's (start_ns, end_ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("call"):
            fn()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "call"]
    assert len(ev) == 1
    return ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def _ancestors(s, by_id):
    while s.parent in by_id:
        s = by_id[s.parent]
        yield s


def test_without_a_profiler_a_span_is_one_shared_noop(trainer):
    a = profiler.span("chain.step", torch.zeros(1), t=3)
    b = profiler.span("trainer.step", torch.device("cpu"))
    assert a is b
    with a as inside:
        assert inside is None
    trainer.optimize_parameters_resident(2, 1)
    assert profiler.spans() == []


def test_a_resident_step_records_its_phases_under_its_step(trainer):
    step = trainer.step
    _profiled(lambda: trainer.optimize_parameters_resident(2, 1))
    named = _by_name(profiler.spans())
    (s,) = named["trainer.step"]
    assert s.attrs == {"step": step} and s.parent is None
    for name in PHASES:
        (p,) = named[name]
        assert p.parent == s.id and p.thread == s.thread
        assert s.start_ns <= p.start_ns <= p.end_ns <= s.end_ns
    fwd, bwd, opt = (named[n][0] for n in ("trainer.forward",
                                           "trainer.backward",
                                           "trainer.optimizer"))
    assert fwd.end_ns <= bwd.start_ns and bwd.end_ns <= opt.start_ns
    # no device on the CPU: no device time
    assert all(x.device_ms is None for x in profiler.spans())


def test_the_plain_backwards_of_k1_and_k2_sit_under_the_backward(trainer):
    _profiled(lambda: trainer.optimize_parameters_resident(2, 1))
    recorded = profiler.spans()
    by_id = {s.id: s for s in recorded}
    named = _by_name(recorded)
    kernel = named["ops.kernel_backward"]
    # dropout sends every block2 through K2; block1 and the final Block
    # through K1; no plain backward is left on their path
    assert "ops.plain_backward" not in named
    assert {s.attrs["op"] for s in kernel} == {"gn_silu_conv3x3",
                                               "group_norm"}
    for s in kernel:
        names = [a.name for a in _ancestors(s, by_id)]
        assert names[:1] in (["trainer.backward"], ["ops.kernel_backward"])
        assert "trainer.backward" in names and names[-1] == "trainer.step"


def test_a_span_on_another_thread_hangs_under_the_newest_open_one():
    seen = {}

    def worker():
        with profiler.span("ops.plain_backward", op="x") as s:
            seen["inner"] = s

    def run():
        with profiler.span("trainer.step"), \
                profiler.span("trainer.backward") as outer:
            seen["outer"] = outer
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()

    _profiled(run)
    inner, outer = seen["inner"], seen["outer"]
    assert inner.parent == outer.id and inner.thread != outer.thread
    assert [s.name for s in profiler.spans()] == [
        "ops.plain_backward", "trainer.backward", "trainer.step"]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm++"])
def test_a_chain_step_records_the_network_inside_it(sampler):
    t = _trainer(dropout=0.0, phase="val")
    diff = t.opt["model"]["diffusion"]
    diff.update(sampler=sampler, sampler_steps=3, eta=1.0)
    x = torch.zeros(1, 3, 16, 16)
    g = torch.Generator().manual_seed(0)
    net = t._eval_params()
    with torch.inference_mode():
        if sampler == "ddpm":
            steps = [t.sched.num_timesteps - 1]
            call = lambda: t.diffusion.p_sample_step(
                net, t.sched, x, steps[0], x, generator=g)
        else:
            call = lambda: t._chain_fn(False)(net, x, g)
        _profiled(call)
    named = _by_name(profiler.spans())
    outer, eps = named["chain.step"], named["chain.eps"]
    assert len(outer) == len(eps) == (1 if sampler == "ddpm" else 3)
    by_id = {s.id: s for s in outer}
    for e in eps:
        assert by_id[e.parent].attrs == e.attrs and set(e.attrs) == {"t"}
    if sampler == "ddpm":
        assert eps[0].attrs == {"t": t.sched.num_timesteps - 1}
    else:
        ts = [s.attrs["t"] for s in sorted(outer, key=lambda s: s.start_ns)]
        assert ts == sorted(ts, reverse=True) and ts[0] == 9 and ts[-1] == 0


def test_spans_lie_inside_the_profilers_event_on_its_clock(trainer):
    def call():
        trainer.optimize_parameters_resident(2, 1)
        with torch.inference_mode():
            trainer.diffusion.p_sample_step(
                trainer._eval_params(), trainer.sched,
                torch.zeros(1, 3, 16, 16), 5, torch.zeros(1, 3, 16, 16),
                generator=torch.Generator().manual_seed(0))

    start, end = _profiled(call)
    recorded = profiler.spans()
    assert {"trainer.step", "chain.step", "ops.kernel_backward"} <= {
        s.name for s in recorded}
    for s in recorded:
        assert start <= s.start_ns <= s.end_ns <= end, s.name


def test_trace_writes_the_spans_into_its_file(tmp_path, trainer):
    with profiler.trace(str(tmp_path)):
        with record_function("call"):
            trainer.optimize_parameters_resident(2, 1)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    call = [e for e in events if e.get("name") == "call"]
    ours = [e for e in events if e.get("cat") == "sr3_span"]
    assert len(call) == 1
    assert {e["name"] for e in ours} == {"trainer.step",
                                         "ops.kernel_backward", *PHASES}
    assert len(ours) == len(profiler.spans())
    c0, c1 = call[0]["ts"], call[0]["ts"] + call[0]["dur"]
    for e in ours:
        assert e["ph"] == "X" and e["pid"] == call[0]["pid"]
        assert c0 <= e["ts"] <= e["ts"] + e["dur"] <= c1 + 1e-3, e["name"]
    step = next(e for e in ours if e["name"] == "trainer.step")
    assert step["tid"] == call[0]["tid"] and "step" in step["args"]


@pytest.mark.parametrize("dropout, phase, split", [
    (0.1, "train", True), (0.1, "val", False), (0.0, "train", False)])
def test_block_counters_follow_dropout_and_mode(dropout, phase, split):
    t = _trainer(dropout=dropout)
    net = t.netG.train(phase == "train")
    resnets = sum(isinstance(m, unet.ResnetBlock) for m in net.modules())
    blocks = sum(isinstance(m, unet.Block) for m in net.modules())
    assert blocks == 2 * resnets + 1
    before = profiler.counts()
    with torch.no_grad():
        net(torch.zeros(1, 6, 16, 16).contiguous(memory_format=unet.CL),
            torch.full((1,), 0.5), generator=torch.Generator())
    after = profiler.counts()
    fused = after["block.fused"] - before["block.fused"]
    n_split = after["block.split"] - before["block.split"]
    assert (fused, n_split) == ((resnets + 1, resnets) if split
                                else (blocks, 0))


@pytest.mark.parametrize("module, attr, name", [
    (conv_fused, "counter", "gn_silu_conv3x3"),
    (conv_fused, "halo_counter", "gn_silu_conv3x3_halo"),
    (groupnorm, "counter", "group_norm"),
    (groupnorm, "stats_counter", "gn_stats"),
    (attention, "counter", "flash_attention_fwd"),
    (attention, "dkv_counter", "flash_attention_bwd_dkv"),
    (attention, "dq_counter", "flash_attention_bwd_dq"),
])
def test_kernel_counters_keep_their_names_and_n(module, attr, name):
    c = getattr(module, attr)
    assert c.name == name and isinstance(c.n, int)
    n = c.n
    try:
        c.n += 3
        assert profiler.counts()[name] == n + 3
    finally:
        c.n = n
    assert profiler.counts()[name] == n


def test_only_the_newest_spans_are_kept():
    def run():
        for i in range(profiler.MAX_SPANS + 5):
            with profiler.span("chain.step", t=i):
                pass

    _profiled(run)
    recorded = profiler.spans()
    assert len(recorded) == profiler.MAX_SPANS
    assert recorded[0].attrs == {"t": 5}
    profiler.reset_spans()
    assert profiler.spans() == []
