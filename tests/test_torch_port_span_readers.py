"""The benchmark's readers of the port's own spans and counters
(``portbench/metrics``: ``unet_device_ms.sample``,
``chain_device_ms.sample``, ``{forward,backward,optimizer}_device_ms.train``,
``plain_backward_pct.train``, ``fused_block_pct.train``,
``kernel_backward_pct.train``; for the ADM cell ``attention_pct.sample``,
``resample_pct.sample`` and ``scale_shift_fused_pct.sample``).

Fed a registry with known device milliseconds and counts, each gives the
value its docstring defines, and None where the registry, the spans or
their device times are absent (an older program, a CPU run). Each entry
in ``BENCHMARK.json`` resolves through ``cells.reader`` and keeps the
benchmark's contract."""

import types

import pytest

from portbench import cells
from portbench.tests import test_portbench_names as contract
from sr3_tpu_torch.utils import profiler

ADM = ("adm_128_512.ancestral250_b8",)
SAMPLE = ("sr3_16_128.ancestral_b128", "sr3_64_512.ancestral_b8") + ADM
TRAIN = ("sr3_16_128.train_b128", "sr3_64_512.train_b16")
NEW = {
    "unet_device_ms.sample": ("program_span", "unet", SAMPLE),
    "chain_device_ms.sample": ("program_span", "chain", SAMPLE),
    "forward_device_ms.train": ("program_span", "unet", TRAIN),
    "backward_device_ms.train": ("program_span", "unet", TRAIN),
    "optimizer_device_ms.train": ("program_span", "trainer", TRAIN),
    "plain_backward_pct.train": ("program_span", "kernels", TRAIN),
    "fused_block_pct.train": ("program_counter", "kernels", TRAIN),
    "kernel_backward_pct.train": ("program_span", "kernels", TRAIN),
    "scale_shift_fused_pct.sample": ("program_counter", "kernels", ADM),
    "attention_pct.sample": ("program_span", "unet", ADM),
    "resample_pct.sample": ("program_span", "unet", ADM),
}
SPAN_READERS = sorted(n for n, v in NEW.items() if v[0] == "program_span")


class _Registry:
    """Spans as (name, parent index or None, device ms) in start order."""

    def __init__(self, rows):
        self.rows = rows

    def spans(self):
        out = []
        for i, (name, parent, ms) in enumerate(self.rows):
            out.append(types.SimpleNamespace(
                id=i + 1, name=name, attrs={}, thread=1, start_ns=i,
                end_ns=i + 1, device_ms=ms,
                parent=None if parent is None else parent + 1))
        return out


CHAIN = [
    ("chain.step", None, 10.0), ("chain.eps", 0, 8.0),
    ("chain.step", None, 12.0), ("chain.eps", 2, 9.0),
]
# two ADM steps: attention and resampling blocks inside the network's call
ADM_CHAIN = [
    ("chain.step", None, 10.0), ("chain.eps", 0, 8.0),
    ("unet.attention", 1, 1.0), ("unet.resample", 1, 2.0),
    ("unet.attention", 1, 0.5),
    ("chain.step", None, 12.0), ("chain.eps", 5, 9.0),
    ("unet.attention", 6, 1.5), ("unet.resample", 6, 2.5),
]
TRAINING = [
    ("trainer.step", None, 20.0),                                   # 0
    ("trainer.forward", 0, 3.0), ("trainer.backward", 0, 10.0),    # 1, 2
    ("ops.plain_backward", 2, 2.0), ("ops.plain_backward", 2, 3.0),
    ("ops.plain_backward", 4, 1.0),  # inside another: not counted again
    ("trainer.optimizer", 0, 0.5),                                  # 6
    ("trainer.step", None, 22.0),                                   # 7
    ("trainer.forward", 7, 4.0), ("trainer.backward", 7, 12.0),    # 8, 9
    ("ops.plain_backward", 9, 4.0),
    ("trainer.optimizer", 7, 0.5),
    ("ops.plain_backward", None, 100.0),  # under no backward
]
# the same steps with the kernel backwards in the plain ones' place
KERNEL_TRAINING = [(name.replace("ops.plain_backward", "ops.kernel_backward"),
                    parent, ms) for name, parent, ms in TRAINING]
WANT = {
    "unet_device_ms.sample": (CHAIN, 8.5),
    "chain_device_ms.sample": (CHAIN, 2.5),
    "forward_device_ms.train": (TRAINING, 3.5),
    "backward_device_ms.train": (TRAINING, 11.0),
    "optimizer_device_ms.train": (TRAINING, 0.5),
    "plain_backward_pct.train": (TRAINING, 100.0 * 9.0 / 22.0),
    "kernel_backward_pct.train": (KERNEL_TRAINING, 100.0 * 9.0 / 22.0),
    "attention_pct.sample": (ADM_CHAIN, 100.0 * 3.0 / 17.0),
    "resample_pct.sample": (ADM_CHAIN, 100.0 * 4.5 / 17.0),
}


def _feed(monkeypatch, rows=(), counts=None):
    reg = _Registry(list(rows))
    monkeypatch.setattr(profiler, "spans", reg.spans)
    monkeypatch.setattr(profiler, "counts", lambda: dict(counts or {}))


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_reader_gives_its_value(monkeypatch, name):
    rows, want = WANT[name]
    _feed(monkeypatch, rows)
    assert cells.reader(name)({}) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_span_reader_gives_none_without_device_times(monkeypatch, name):
    rows, _ = WANT[name]
    _feed(monkeypatch, [(n, p, None) for n, p, _ in rows])
    assert cells.reader(name)({}) is None
    _feed(monkeypatch, [])
    assert cells.reader(name)({}) is None


@pytest.mark.parametrize("counts, want", [
    ({"block.fused": 30, "block.split": 10, "gn_silu_conv3x3": 5}, 75.0),
    ({"block.fused": 3, "block.split": 1, "gn_silu_conv3x3_halo": 2}, 75.0),
    # no K1 launch (a CPU run): no reading
    ({"block.fused": 30, "block.split": 10, "gn_silu_conv3x3": 0}, None),
    ({"block.fused": 0, "block.split": 0, "gn_silu_conv3x3": 5}, None),
    ({"gn_silu_conv3x3": 5}, None),
])
def test_the_block_share_reads_the_counters(monkeypatch, counts, want):
    _feed(monkeypatch, counts=counts)
    got = cells.reader("fused_block_pct.train")({})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("counts, want", [
    ({"block.scale_shift": 42, "block.scale_shift_split": 0,
      "gn_silu_conv3x3": 75}, 100.0),
    ({"block.scale_shift": 3, "block.scale_shift_split": 1,
      "gn_silu_conv3x3": 2}, 75.0),
    # the program counts no other route: every scale-shift block is K1's
    ({"block.scale_shift": 42, "gn_silu_conv3x3": 75}, 100.0),
    # no K1 launch (a CPU run), no ADM blocks, or no counters: no reading
    ({"block.scale_shift": 42, "block.scale_shift_split": 0,
      "gn_silu_conv3x3": 0}, None),
    ({"block.scale_shift": 0, "block.scale_shift_split": 0,
      "gn_silu_conv3x3": 5}, None),
    ({"block.fused": 30, "block.split": 10, "gn_silu_conv3x3": 5}, None),
])
def test_the_scale_shift_share_reads_the_counters(monkeypatch, counts, want):
    _feed(monkeypatch, counts=counts)
    got = cells.reader("scale_shift_fused_pct.sample")({})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_reader_gives_none_without_the_registry(monkeypatch, name):
    # an older program: a profiler module with neither spans nor counts
    monkeypatch.delattr(profiler, "spans")
    monkeypatch.delattr(profiler, "counts")
    assert cells.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_entry_resolves_and_keeps_the_contract(name):
    bench = cells.benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    source, layer, workloads = NEW[name]
    assert (entry["source"], entry["layer"]) == (source, layer)
    assert tuple(entry["workloads"]) == workloads
    assert callable(cells.reader(name))
    for w in workloads:
        _, e2e, per_layer = cells.cell(bench, w)
        assert entry["moves"] in {m["name"] for m in e2e}
        assert name in {m["name"] for m in per_layer}
    # the new entries are the last of their list, after the accepted ones
    assert bench["per_layer"].index(entry) >= len(bench["per_layer"]) - len(
        NEW)
    contract.test_top_level_keys_and_sizes()
    contract.test_entries_keys_names_and_units("per_layer")
    contract.test_cells_configs_and_metrics_fit_together()
