"""The reference against the port: its FLOP count equals the port's own
count, and at a tiny width on the CPU one chain step and one train step of
the port agree with it."""

import time

import pytest

from portbench import cells, costs
from portbench.kinds import driver
from portbench.tests.portbench_tiny import tiny_opt


@pytest.mark.parametrize("config, gflop", [("sr3_16_128", 92.35),
                                           ("sr3_64_512", 997.0)])
def test_flop_count_matches_the_ports(config, gflop):
    from sr3_tpu_torch.utils import flops

    opt = cells.config(config)["opt"]
    fwd = costs.forward_flops(opt)
    assert fwd == flops.forward_flops(opt)
    assert fwd / 1e9 == pytest.approx(gflop, abs=0.05)
    assert costs.train_step_flops(opt) == flops.train_step_flops(opt)


def test_k1_sites_are_every_block_in_serving_and_block1_in_training():
    opt = cells.config("sr3_16_128")["opt"]
    serve = costs.k1_sites(opt, 8, training=False)
    train = costs.k1_sites(opt, 8, training=True)
    # 27 ResnetBlocks (10 down, 2 mid, 15 up), two Blocks each, and the
    # final Block
    assert len(serve) == 55 and len(train) == 28
    assert sum(s["residual"] for s in serve) == 27
    assert all(s["b"] == 8 for s in serve)
    # with remat each block's calls run again in the recompute, the final
    # Block's once: 17 ResnetBlocks of one res block a level at 64->512
    remat = costs.k1_sites(cells.config("sr3_64_512")["opt"], 8, True)
    assert len(remat) == 17 * 2 + 1
    nbytes, flops = costs.k1_bytes_and_flops(serve[0])
    assert flops == 2 * 8 * 128 * 128 * 64 * 64 * 9 and nbytes > 0


@pytest.mark.parametrize("kind, mix, batch", [("sample", "ancestral_b8", 4),
                                              ("train", "train_b128", 4)])
def test_the_port_agrees_with_the_reference_on_the_cpu(kind, mix, batch):
    traffic = dict(cells.traffic(mix), batch=batch, resident=8)
    run = driver(kind).run(tiny_opt(), traffic, 2 ** 31 + 11, 0.2, False,
                           "cpu", time.time())
    assert run.attempted >= 1
    # float32 on both sides: rounding alone
    assert run.numbers and max(run.numbers.values()) < 1e-4, run.numbers
