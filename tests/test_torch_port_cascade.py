"""The port's cascade (sr3_tpu_torch/training/cascade.py and the
``python -m sr3_tpu_torch.cascade`` driver) against the JAX package's.

- tests/test_cascade.py's four cases, on the port;
- ``to_condition`` equal to the JAX package's, bit for bit, on the same
  arrays (its resize is the port's numpy copy of Pillow's);
- a two-stage cascade, a tiny unconditional 8x8 ddpm stage then a tiny
  8->16 sr3 stage, against the JAX package's ``run_stage`` stage by stage:
  the port's stages load the JAX stages' initial weights (exported to
  ``_gen.pth``) and take each image's noise from the JAX chain's own
  ``jax.random`` draws (``fold_in(base key, image)``, then the loop's
  splits) through ``noise_stream``. Stage 1's samples within 5e-4; stage 2
  runs on both sides from the JAX stage 1's outputs (the same
  conditioning, so a uint8 rounding flip in stage 1 cannot hide a fault in
  stage 2), within 5e-4 (four chained float32 UNet steps);
- the driver on the CPU, in a subprocess, with one -r per stage.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3_tpu.training.cascade import run_stage as jax_run_stage
from sr3_tpu.training.cascade import to_condition as jax_to_condition
from sr3_tpu.training.trainer import Trainer as JaxTrainer
from sr3_tpu.utils.config import dict_to_nonedict as jax_nonedict
from sr3_tpu.utils.torch_compat import flax_params_to_torch_state_dict
from sr3_tpu_torch.models.diffusion import GaussianDiffusion
from sr3_tpu_torch.models.networks import define_G
from sr3_tpu_torch.training import evaluation
from sr3_tpu_torch.training.cascade import (load_input_images, run_cascade,
                                            run_stage, to_condition)
from sr3_tpu_torch.utils.config import dict_to_nonedict
from sr3_tpu_torch.utils.torch_compat import unet_key_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("SR3_PLATFORM", "cpu")


def _stage_opt(tmp_path, name, size, conditional, resume_state=None):
    """tests/test_cascade.py's stage config."""
    return dict_to_nonedict({
        "name": name, "phase": "val", "seed": 0,
        "path": {"checkpoint": str(tmp_path / name / "ckpt"),
                 "resume_state": resume_state},
        "datasets": {"val": {"batch_size": 2, "r_resolution": size}},
        "model": {
            "which_model_G": "sr3" if conditional else "ddpm",
            "finetune_norm": False, "dtype": "float32",
            "unet": {"in_channel": 6 if conditional else 3,
                     "out_channel": 3, "inner_channel": 8, "norm_groups": 4,
                     "channel_multiplier": [1, 2], "attn_res": [4],
                     "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {
                "train": {"schedule": "linear", "n_timestep": 8,
                          "linear_start": 1e-6, "linear_end": 1e-2},
                "val": {"schedule": "linear", "n_timestep": 4,
                        "linear_start": 1e-6, "linear_end": 1e-2}},
            "diffusion": {"image_size": size, "channels": 3,
                          "conditional": conditional},
        },
        "train": {"n_iter": 1, "optimizer": {"type": "adam", "lr": 1e-3}},
    })


def test_to_condition_resizes_to_stage_size():
    img = np.random.default_rng(0).uniform(-1, 1, (8, 8, 3)).astype(
        np.float32)
    cond = to_condition(img, 16)
    assert cond.shape == (16, 16, 3) and cond.dtype == np.float32
    assert cond.min() >= -1.0 and cond.max() <= 1.0
    # bicubic upsample of a constant image stays (quantized-)constant
    flat = to_condition(np.full((8, 8, 3), 0.25, np.float32), 16)
    assert float(np.ptp(flat)) < 1e-6


@pytest.mark.parametrize("src,size", [((8, 8), 16), ((16, 16), 128),
                                      ((128, 128), 1024), ((64, 64), 64),
                                      ((40, 24), 16)])
def test_to_condition_equals_the_jax_packages(src, size):
    img = np.random.default_rng(sum(src)).uniform(
        -1.2, 1.2, src + (3,)).astype(np.float32)
    got = to_condition(img, size)
    want = jax_to_condition(img, size)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_uncond_seed_then_sr_stage(tmp_path):
    opts = [_stage_opt(tmp_path, "seed8", 8, conditional=False),
            _stage_opt(tmp_path, "sr8_16", 16, conditional=True)]
    out_dir = tmp_path / "out"
    images = run_cascade(opts, n_samples=3, out_dir=str(out_dir))
    assert len(images) == 3
    assert all(img.shape == (16, 16, 3) for img in images)
    names = {p.name for p in out_dir.iterdir()}
    assert {"1_1_8.png", "2_1_16.png", "final_1.png"} <= names
    # a conditional first stage takes input images; read back from PNGs
    back = load_input_images(str(out_dir))
    assert len(back) == len(names) and back[0].dtype == np.float32


def test_conditional_stage_from_input_images(tmp_path):
    opt = _stage_opt(tmp_path, "sr_only", 16, conditional=True)
    inputs = [np.random.default_rng(i).uniform(-1, 1, (8, 8, 3)).astype(
        np.float32) for i in range(2)]
    outs = run_stage(opt, images=inputs)
    assert len(outs) == 2 and outs[0].shape == (16, 16, 3)


def test_conditional_stage_without_inputs_raises(tmp_path):
    opt = _stage_opt(tmp_path, "sr_noin", 16, conditional=True)
    with pytest.raises(ValueError):
        run_stage(opt, images=None)
    with pytest.raises(ValueError, match="unconditional"):
        run_cascade([_stage_opt(tmp_path, "u", 8, conditional=False)],
                    input_images=[np.zeros((8, 8, 3), np.float32)])


def _export_jax_stage(tmp_path, opt):
    """The JAX stage's initial weights (its Trainer, seeded as run_stage
    builds it) as a ``_gen.pth`` prefix the port loads."""
    jt = JaxTrainer(jax_nonedict(dict(opt)))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    net = define_G(opt, device="meta").denoise_fn
    sd = flax_params_to_torch_state_dict(params, **unet_key_config(net))
    prefix = str(tmp_path / f"{opt['name']}_jax")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
               prefix + "_gen.pth")
    return prefix


def _jax_image_draws(base_key, index, size, steps):
    """Image ``index``'s draws in the JAX package's grouped chain: its key
    fold_in(base, index), split into the initial noise and the chain key,
    one split a step (p_sample_loop)."""
    key = jax.random.fold_in(base_key, index)
    key_init, key = jax.random.split(key)
    shape = (1, size, size, 3)
    init = jax.random.normal(key_init, shape, dtype=jnp.float32)
    noise = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, shape,
                                                  dtype=jnp.float32)))
    return np.asarray(init), np.stack(noise)


def _inject_jax_draws(monkeypatch, base_key, size, steps):
    """The port's grouped chains take each image's JAX draws: the group's
    first image index is read where the evaluator makes its generators."""
    group = {}
    make = evaluation.GroupedEvaluator._generators

    def generators(self, idx0):
        group["idx0"] = idx0
        return make(self, idx0)

    chain = GaussianDiffusion.p_sample_loop

    def p_sample_loop(self, net, sched, x_in, generator=None, **kw):
        draws = [_jax_image_draws(base_key, group["idx0"] + j, size, steps)
                 for j in range(len(generator))]
        init = np.concatenate([d[0] for d in draws])
        noise = np.concatenate([d[1] for d in draws], axis=1)
        kw["noise_stream"] = (torch.from_numpy(init).permute(0, 3, 1, 2),
                              torch.from_numpy(noise).permute(0, 1, 4, 2, 3))
        return chain(self, net, sched, x_in, generator, **kw)

    monkeypatch.setattr(evaluation.GroupedEvaluator, "_generators",
                        generators)
    monkeypatch.setattr(GaussianDiffusion, "p_sample_loop", p_sample_loop)


def test_two_stage_cascade_matches_the_jax_package_stage_by_stage(
        tmp_path, monkeypatch):
    opt1 = _stage_opt(tmp_path, "seed8", 8, conditional=False)
    opt2 = _stage_opt(tmp_path, "sr8_16", 16, conditional=True)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    jax1 = jax_run_stage(jax_nonedict(dict(opt1)), n_samples=3, base_rng=k1)
    jax2 = jax_run_stage(jax_nonedict(dict(opt2)), images=jax1, base_rng=k2)

    port1 = _stage_opt(tmp_path, "seed8", 8, conditional=False,
                       resume_state=_export_jax_stage(tmp_path, opt1))
    port2 = _stage_opt(tmp_path, "sr8_16", 16, conditional=True,
                       resume_state=_export_jax_stage(tmp_path, opt2))
    with monkeypatch.context() as m:
        _inject_jax_draws(m, k1, 8, 4)
        out1 = run_stage(port1, n_samples=3)
    with monkeypatch.context() as m:
        _inject_jax_draws(m, k2, 16, 4)
        out2 = run_stage(port2, images=jax1)
    assert len(out1) == 3 and len(out2) == 3
    for got, want in zip(out1, jax1):
        assert got.shape == (8, 8, 3)
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=0)
    for got, want in zip(out2, jax2):
        assert got.shape == (16, 16, 3)
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-4, rtol=0)
    # the draws matter: another base key gives other samples
    assert not np.allclose(out1[0], out1[1], atol=1e-2)


def test_cascade_driver_on_the_cpu(tmp_path):
    """``python -m sr3_tpu_torch.cascade`` with two stage configs, -r per
    stage ('-' keeps the config's), -n and -o."""
    import json

    cfgs = []
    for name, size, cond in (("seed8", 8, False), ("sr8_16", 16, True)):
        opt = dict(_stage_opt(tmp_path, name, size, cond))
        opt["path"] = {"log": "logs", "results": "results",
                       "checkpoint": "checkpoint", "resume_state": None}
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(opt))
        cfgs += ["-c", str(path)]
    prefix = _export_jax_stage(tmp_path, _stage_opt(tmp_path, "sr8_16", 16,
                                                     True))
    env = dict(os.environ, SR3_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "sr3_tpu_torch.cascade", *cfgs, "-r", "-",
         "-r", prefix, "-n", "2", "-o", str(tmp_path / "out")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["1_1_8.png", "1_2_8.png", "2_1_16.png", "2_2_16.png",
                     "final_1.png", "final_2.png"]
    assert "RANDOMLY INITIALIZED" in proc.stderr  # stage 1 kept its None
    assert "Loading pretrained model for G" in proc.stderr
