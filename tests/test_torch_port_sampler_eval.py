"""The port's sampler comparison (``python -m sr3_tpu_torch.sampler_eval``)
on the CPU, and the EMA weights of a resume in the val phase.

A micro model (16x16 images, T=4) with a ``.pth`` saved in the test, as
tests/test_sampler_eval.py drives the JAX tool: ``[image][rep]`` score
grids, means and SEs, the paired deltas against the first sampler with the
cluster-robust SE, the JAX tool's row keys and artifact, and the refusal of
a spec without steps. A sampler listed twice draws the same noise for every
(image, rep), so its deltas are exactly 0. The JAX trainer restores its EMA
parameters in every phase (sr3_tpu/training/trainer.py:720-727); the port
does too, so a val-phase resume samples with the EMA weights.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sr3_tpu_torch import sampler_eval
from sr3_tpu_torch.training.trainer import Trainer
from sr3_tpu_torch.utils.config import dict_to_nonedict

ROW_KEYS = {"sampler", "eta", "nfe", "reps", "psnr_db", "ssim", "avg_psnr_db",
            "se_psnr_db", "avg_ssim", "se_ssim", "sample_seconds_total"}
DELTA_KEYS = {"d_psnr_vs_first", "d_psnr_se", "d_ssim_vs_first",
              "d_ssim_se", "d_psnr_se_cluster", "d_ssim_se_cluster"}


def _write_dataset(root, n=2):
    for d in ("hr_16", "sr_2_16", "lr_2"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    for i in range(n):
        for d, size in (("hr_16", 16), ("sr_2_16", 16), ("lr_2", 2)):
            arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / d / f"{i:05d}.png")


def _opt(tmp_path, ema=False):
    sched = {"schedule": "linear", "n_timestep": 4,
             "linear_start": 1e-6, "linear_end": 1e-2}
    data = {"name": "micro", "dataroot": str(tmp_path / "data"),
            "datatype": "img", "l_resolution": 2, "r_resolution": 16}
    opt = {
        "name": "sampler_eval_test", "phase": "train", "seed": 0,
        "path": {"checkpoint": str(tmp_path / "ckpt"), "resume_state": None},
        "datasets": {
            "train": dict(data, mode="HR", batch_size=2, data_len=-1),
            "val": dict(data, mode="LRHR", data_len=2),
        },
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"train": sched, "val": sched},
            "diffusion": {"image_size": 16, "channels": 3,
                          "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-3}},
    }
    if ema:
        opt["train"]["ema_scheduler"] = {"use_ema": True, "ema_decay": 0.5,
                                         "step_start_ema": 0}
    return opt


def _checkpoint(tmp_path, opt, steps=0):
    """A train-phase Trainer of ``opt`` after ``steps`` steps on seeded
    batches, saved; returns (trainer, resume prefix)."""
    os.makedirs(tmp_path / "ckpt", exist_ok=True)
    t = Trainer(dict_to_nonedict(copy.deepcopy(opt)), device="cpu")
    t.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"])
    rng = np.random.default_rng(1)
    for _ in range(steps):
        t.feed_data({k: rng.uniform(-1, 1, (2, 16, 16, 3))
                     for k in ("HR", "SR")})
        t.optimize_parameters()
    t.save_network(epoch=0, iter_step=steps)
    return t, str(tmp_path / "ckpt" / f"I{steps}_E0")


@pytest.fixture()
def setup(tmp_path, monkeypatch):
    monkeypatch.setenv("SR3_PLATFORM", "cpu")
    _write_dataset(tmp_path / "data")
    opt = _opt(tmp_path)
    _, resume = _checkpoint(tmp_path, opt)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(opt))
    return cfg, resume


def test_sampler_eval_cli(tmp_path, setup, capsys):
    cfg, resume = setup
    out = tmp_path / "requal.json"
    sampler_eval.main([
        "--config", str(cfg), "--resume", resume,
        "--samplers", "ddpm:4", "ddim:2", "ddpm:4", "--eta", "1.0",
        "--reps", "2", "--out", str(out)])

    report = json.loads(out.read_text())
    assert set(report) == {"config", "resume", "val_timesteps", "results"}
    assert report["val_timesteps"] == 4
    rows = report["results"]
    assert [r["sampler"] for r in rows] == ["ddpm:4", "ddim:2", "ddpm:4"]
    base, ddim, again = rows
    assert base["nfe"] == 4 and ddim["nfe"] == 2
    assert set(base) == ROW_KEYS
    assert set(ddim) == set(again) == ROW_KEYS | DELTA_KEYS
    for r in rows:
        grid = np.asarray(r["psnr_db"])
        assert grid.shape == (2, 2)  # [image][rep]
        assert np.isfinite(grid).all()
        sgrid = np.asarray(r["ssim"])
        assert sgrid.shape == (2, 2)
        assert (sgrid <= 1.0).all() and (sgrid >= -1.0).all()
        assert r["avg_psnr_db"] == pytest.approx(grid.mean(), abs=0.01)
        assert r["se_psnr_db"] >= 0
    # the reps of one image draw different noise
    assert not np.array_equal(*np.asarray(base["psnr_db"]).T)

    dp = np.asarray(ddim["psnr_db"]) - np.asarray(base["psnr_db"])
    assert ddim["d_psnr_vs_first"] == pytest.approx(dp.mean(), abs=0.01)
    pi = dp.mean(axis=1)
    assert ddim["d_psnr_se_cluster"] == pytest.approx(
        pi.std(ddof=1) / np.sqrt(2), abs=0.01)
    assert ddim["d_ssim_vs_first"] == pytest.approx(
        (np.asarray(ddim["ssim"]) - np.asarray(base["ssim"])).mean(),
        abs=1e-3)

    # the same sampler again: the same noise, so exactly the same scores
    assert again["psnr_db"] == base["psnr_db"]
    assert again["ssim"] == base["ssim"]
    assert all(again[k] == 0 for k in DELTA_KEYS)

    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [json.loads(ln) for ln in lines] == rows


def test_a_spec_without_steps_is_refused(setup):
    cfg, resume = setup
    with pytest.raises(SystemExit):
        sampler_eval.main(["--config", str(cfg), "--resume", resume,
                           "--samplers", "dpm++"])


def test_scores_do_not_depend_on_the_grouping(setup):
    """Image i, rep k draws from its own generator: image 0 scored alone
    gets the scores it gets in the group of both images."""
    cfg, resume = setup
    from sr3_tpu_torch.data.loader import create_dataset
    from sr3_tpu_torch.training.evaluation import per_image
    from sr3_tpu_torch.utils.config import load_config

    opt = load_config(str(cfg))
    opt["phase"] = "val"
    opt["path"]["resume_state"] = resume
    trainer = Trainer(opt, device="cpu")
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   "val")
    items = list(per_image(create_dataset(opt["datasets"]["val"], "val")))
    psnr, ssim, _ = sampler_eval.score_grid(trainer, items, 2, seed=0)
    alone_psnr, alone_ssim, _ = sampler_eval.score_grid(trainer, items[:1],
                                                        2, seed=0)
    np.testing.assert_allclose(alone_psnr, psnr[:1], rtol=1e-5)
    np.testing.assert_allclose(alone_ssim, ssim[:1], rtol=1e-5)


def test_a_val_phase_resume_samples_with_the_ema_weights(tmp_path):
    """EMA on: the val-phase Trainer resumed from a train checkpoint holds
    the EMA weights of its _opt.pth in its sampling network, not the raw
    weights of its _gen.pth."""
    opt = _opt(tmp_path, ema=True)
    trained, resume = _checkpoint(tmp_path, opt, steps=2)
    val = copy.deepcopy(opt)
    val["phase"] = "val"
    val["path"]["resume_state"] = resume
    t = Trainer(dict_to_nonedict(val), device="cpu")
    net = t._eval_params()
    moved = 0
    for (name, p), ema, raw in zip(net.named_parameters(),
                                   trained.ema.values(),
                                   trained.netG.parameters()):
        torch.testing.assert_close(p, ema, rtol=0, atol=0, msg=name)
        moved += not torch.equal(ema, raw)
    assert moved > 0


@pytest.mark.parametrize("ema", [True, False])
def test_a_val_phase_resume_samples_with_the_jax_trainers_weights(tmp_path,
                                                                  ema):
    """The JAX val-phase Trainer resumed from a checkpoint of 2 EMA train
    steps samples with its ema_params when EMA is on, else with its params
    (sr3_tpu/training/trainer.py load_network, _eval_params). The same
    weights, carried into the port's _gen.pth and _opt.pth through
    torch_compat, give the port's val-phase Trainer the same sampling
    network, exactly."""
    import jax

    from sr3_tpu.parallel.mesh import create_mesh
    from sr3_tpu.training.trainer import Trainer as JaxTrainer
    from sr3_tpu.utils.config import dict_to_nonedict as jax_nonedict
    from sr3_tpu_torch.models.networks import define_G
    from sr3_tpu_torch.utils.torch_compat import (
        flax_params_to_torch_state_dict, strip_reference_keys,
        unet_key_config)

    opt = _opt(tmp_path, ema=True)
    os.makedirs(tmp_path / "ckpt")
    jt = JaxTrainer(jax_nonedict(copy.deepcopy(opt)),
                    mesh=create_mesh(num_data=1))
    jt.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"],
                              "train")
    rng = np.random.default_rng(1)
    for _ in range(2):
        jt.feed_data({**{k: rng.uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32) for k in ("HR", "SR")},
                      "Index": np.arange(2)})
        jt.optimize_parameters()
    jt.save_network(epoch=0, iter_step=2)
    jt.wait_for_checkpoints()

    val = copy.deepcopy(opt)
    val["phase"] = "val"
    val["train"]["ema_scheduler"]["use_ema"] = ema
    val["path"]["resume_state"] = str(tmp_path / "ckpt" / "I2_E0")
    jval = JaxTrainer(jax_nonedict(copy.deepcopy(val)),
                      mesh=create_mesh(num_data=1))
    keys = unet_key_config(define_G(val, device="cpu").denoise_fn)
    as_torch = lambda tree: {
        k: torch.tensor(v) for k, v in strip_reference_keys(
            flax_params_to_torch_state_dict(jax.device_get(tree),
                                            **keys)).items()}
    want = as_torch(jval._eval_params())
    raw = as_torch(jt.state.params)
    assert any(not torch.equal(want[k], raw[k]) for k in raw) == ema

    # the port's checkpoint of the same weights
    prefix = str(tmp_path / "ckpt" / "I2_E0_port")
    torch.save({"denoise_fn." + k: v for k, v in raw.items()},
               prefix + "_gen.pth")
    torch.save({"epoch": 0, "iter": 2, "scheduler": None, "optimizer": None,
                "ema": as_torch(jt.state.ema_params)}, prefix + "_opt.pth")
    val["path"]["resume_state"] = prefix
    net = Trainer(dict_to_nonedict(val), device="cpu")._eval_params()
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        torch.testing.assert_close(got[name].detach(), w, rtol=0, atol=0,
                                   msg=name)
