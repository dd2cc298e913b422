"""The port's bench (``python -m sr3_tpu_torch.bench``) on the CPU, and its
counted FLOPs (``sr3_tpu_torch/utils/flops.py``).

The bench runs as a subprocess on tests/test_bench.py's tiny config and
knobs, beside the root bench.py on the same: the JAX bench's five lines,
names, order and units, the keys of each of its lines and the device
besides, no MFU from a CPU run. The FLOP count
of one 16->128 reverse step, and of one sr_sr3_64_512 step, is held within
5% of XLA's cost analysis of the JAX package's ``p_sample_step`` (CPU,
float32, batch 1: the count takes no elementwise work, XLA's takes all of
it), and at a tiny config against a
hand sum of 2 * MACs over the convs, linears and the two attention
products.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
from torch import nn

from sr3_tpu.models.networks import define_G as jax_define_G
from sr3_tpu.models.networks import init_params
from sr3_tpu.models.schedule import make_schedule as jax_make_schedule
from sr3_tpu.utils.config import dict_to_nonedict, load_json_with_comments
from sr3_tpu_torch.models.unet import Downsample, Upsample
from sr3_tpu_torch.utils import flops
from sr3_tpu_torch.utils.config import load_config

from test_bench import TINY_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_16_128 = os.path.join(REPO, "configs", "sr_sr3_16_128.json")

# the metric names of the bench's lines, less the config's stem, in order
LINES = ["train_step_throughput", "train_step_loader_throughput",
         "sampling_ddim4_eta1_throughput", "sampling_dpmpp4_throughput",
         "sampling_2000step_throughput"]


def _bench_lines(proc, out, err):
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


def test_bench_cli_prints_the_jax_benchs_lines_on_the_cpu(tmp_path):
    """The port's bench and the root bench.py, side by side on the tiny
    config: the same metric names in the same order, and each line with the
    keys of the root bench's line and the device besides."""
    cfg = tmp_path / "bench_tiny.json"
    cfg.write_text(json.dumps(TINY_CFG))
    env = {
        **os.environ,
        "SR3_PLATFORM": "cpu",
        "OMP_NUM_THREADS": "2",
        "PYTHONPATH": REPO,
        "BENCH_CONFIG": str(cfg),
        "BENCH_BATCH": "2",
        "BENCH_STEPS": "6",
        "BENCH_REPEATS": "1",
        "BENCH_TRAIN_BATCH": "2",
        "BENCH_TRAIN_ITERS": "2",
        "BENCH_DPMPP_STEPS": "4",
        "BENCH_DDIM_STEPS": "4",
    }
    run = lambda args, cwd: subprocess.Popen(
        [sys.executable, *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = [run(["-m", "sr3_tpu_torch.bench"], tmp_path),
             run(["bench.py"], REPO)]
    (port, out, err), root = [(p, *p.communicate(timeout=900))
                              for p in procs]
    lines, jax_lines = _bench_lines(port, out, err), _bench_lines(*root)
    assert "# device: cpu" in err
    assert [m["metric"] for m in lines] == [
        m["metric"] for m in jax_lines] == [f"bench_tiny_{k}" for k in LINES]
    for m, ref in zip(lines, jax_lines):
        assert set(m) - {"device"} == set(ref), (
            m["metric"], set(m) ^ set(ref))
        assert m["device"] == "cpu"
        assert m["unit"] == ref["unit"] == "images/sec/chip"
        assert m["value"] > 0 and m["vs_baseline"] > 0
    assert lines[0]["mfu"] is None and lines[-1]["mfu"] is None
    loader = lines[1]
    assert loader["fraction_of_synthetic_rate"] is not None
    assert loader["transfer_gap_ms"] >= 0
    assert not (loader["input_bound"] and loader["transfer_bound"])
    assert lines[2]["nfe"] == 4 and lines[3]["nfe"] == 4


def test_bench_without_a_card_exits_3(tmp_path):
    """No SR3_PLATFORM=cpu and no CUDA: the probe's canary fails, the
    bench exits 3 and prints no line."""
    env = {k: v for k, v in os.environ.items() if k != "SR3_PLATFORM"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "sr3_tpu_torch.bench"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def _xla_step_flops(config):
    """XLA's cost analysis of the JAX package's p_sample_step of
    ``config``'s model, float32, batch 1, on the CPU (abstract weights)."""
    opt = dict_to_nonedict(load_json_with_comments(config))
    opt["phase"] = "val"
    opt["model"]["dtype"] = "float32"
    diffusion = jax_define_G(opt)
    params = jax.eval_shape(
        lambda: init_params(diffusion, jax.random.PRNGKey(0)))
    size = opt["model"]["diffusion"]["image_size"]
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    sched = jax_make_schedule({"schedule": "linear", "n_timestep": 2000,
                               "linear_start": 1e-6, "linear_end": 1e-2})
    step = jax.jit(lambda p, s, img, k: diffusion.p_sample_step(
        p, s, img, jnp.int32(1000), k, x))
    ca = step.lower(params, sched, x, jax.random.PRNGKey(0)) \
        .compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


@pytest.mark.parametrize("config, counted", [
    ("sr_sr3_16_128.json", 92.35e9), ("sr_sr3_64_512.json", 997.0e9)])
def test_counted_step_flops_within_5pc_of_xla(config, counted):
    """One reverse step per image: 92.35 GFLOP counted against XLA's ~89.13
    at 16->128, 997.0 against ~991.4 at 64->512 without attention."""
    path = os.path.join(REPO, "configs", config)
    ours = flops.forward_flops(load_config(path))
    xla = _xla_step_flops(path)
    assert ours == pytest.approx(counted, rel=1e-3)
    assert abs(ours / xla - 1) <= 0.05, (ours, xla)


def _hand_forward_flops(net):
    """2 * MACs of one batch-1 forward: every conv and linear, and the two
    products of each attention (q k^T and p v), walked level by level."""
    conv = lambda m, r: (2 * m.out_channels * m.in_channels
                         * m.kernel_size[0] * m.kernel_size[1] * r * r)
    lin = lambda m: 2 * m.in_features * m.out_features
    mlp = net.noise_level_mlp
    res = net.image_size
    total = lin(mlp[1]) + lin(mlp[3]) + conv(net.downs[0], res)
    for layer in (*net.downs[1:], *net.mid, *net.ups):
        if isinstance(layer, Downsample):
            res //= 2
            total += conv(layer.conv, res)
        elif isinstance(layer, Upsample):
            res *= 2
            total += conv(layer.conv, res)
        else:
            rb = layer.res_block
            total += (conv(rb.block1.block[3], res)
                      + conv(rb.block2.block[3], res)
                      + lin(rb.noise_func.noise_func[0]))
            if isinstance(rb.res_conv, nn.Conv2d):
                total += conv(rb.res_conv, res)
            if layer.attn is not None:
                c, n = layer.attn.out.in_channels, res * res
                total += (conv(layer.attn.qkv, res) + conv(layer.attn.out, res)
                          + 2 * (2 * n * n * c))
    return total + conv(net.final_conv.block[3], res)


@pytest.mark.parametrize("attn_res", [[64], []])
def test_counted_flops_equal_a_hand_sum(attn_res):
    """The forward count equals the hand sum; the train step counts the
    forward three times (each weight's gradient and each input's), less
    the input gradients of the first conv and the first linear, whose
    inputs need none."""
    from sr3_tpu_torch.models.networks import define_G

    opt = load_config(CONFIG_16_128)
    opt["model"]["unet"].update(inner_channel=8, norm_groups=4,
                                channel_multiplier=[1, 2], attn_res=attn_res,
                                res_blocks=1)
    net = define_G(opt, device="cpu").denoise_fn
    fwd = _hand_forward_flops(net)
    assert flops.forward_flops(opt) == fwd
    first = (2 * net.downs[0].weight[0].numel() * net.downs[0].out_channels
             * net.image_size ** 2
             + 2 * net.noise_level_mlp[1].weight.numel())
    assert flops.train_step_flops(opt) == 3 * fwd - first


def test_mfu_only_from_a_card():
    assert flops.mfu(989e12, 1.0, "cpu") is None
    assert flops.mfu(989e12, 2.0, "cuda") == 0.5
    assert flops.mfu(None, 1.0, "cuda") is None
