"""The port's inference and training CLIs, its independence from JAX and
from the JAX package, and chip_smoke.py's refusal to run without a card, as
real subprocesses on the CPU."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "dataset", "fixtures_16_128")
FIXTURES_512 = os.path.join(REPO, "dataset", "fixtures_64_512")
SCHED = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
         "linear_end": 1e-2}


def _config():
    """Tiny sr3 model over the bundled 16->128 fixtures."""
    data = {"name": "FIX", "dataroot": FIXTURES, "datatype": "img",
            "l_resolution": 16, "r_resolution": 128}
    return {
        "name": "port", "phase": "val", "gpu_ids": [0],
        "path": {"log": "logs", "tb_logger": "tb_logger",
                 "results": "results", "checkpoint": "checkpoint",
                 "resume_state": None},
        "datasets": {
            "train": dict(data, mode="HR", batch_size=2, num_workers=0,
                          use_shuffle=True, data_len=-1),
            "val": dict(data, mode="LRHR", data_len=2),
        },
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": 128, "channels": 3,
                          "conditional": True},
        },
        "train": {"n_iter": 4, "val_freq": 2, "save_checkpoint_freq": 2,
                  "print_freq": 1, "optimizer": {"type": "adam", "lr": 1e-4}},
        "wandb": {"project": "port"},
    }


def _run(args, cwd, timeout=300):
    env = dict(os.environ, SR3_PLATFORM="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{args} failed ({proc.returncode}):\n--- stdout ---\n"
        f"{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc


def test_infer_cli_writes_every_output(tmp_path):
    cfg = tmp_path / "port.json"
    cfg.write_text(json.dumps(_config()))
    _run(["-m", "sr3_tpu_torch.infer", "-c", str(cfg), "-debug"], tmp_path)
    (exp,) = (tmp_path / "experiments").iterdir()
    assert exp.name.startswith("debug_port_")
    results = {p.name for p in (exp / "results").iterdir()}
    # -debug keeps 3 val images
    expected = {f"0_{i}_{tag}.png" for i in (1, 2, 3)
                for tag in ("sr", "hr", "inf", "sr_process")}
    assert results == expected
    log = (exp / "logs" / "train.log").read_text()
    assert "End of Model Inference." in log


def test_train_cli_logs_validates_and_saves(tmp_path):
    """-debug: batch 2, T=10, print and validate every 2 steps, checkpoint
    every 3, 3 val images; the tiny config trains 4 steps with dropout."""
    opt = _config()
    opt["phase"] = "train"
    opt["model"]["unet"]["dropout"] = 0.2
    cfg = tmp_path / "port.json"
    cfg.write_text(json.dumps(opt))
    _run(["-m", "sr3_tpu_torch.sr", "-p", "train", "-c", str(cfg), "-debug"],
         tmp_path)
    (exp,) = (tmp_path / "experiments").iterdir()
    log = (exp / "logs" / "train.log").read_text()
    losses = [float(line.split("l_pix: ")[1].split()[0])
              for line in log.splitlines() if "l_pix: " in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert log.count("# Validation # PSNR: ") == 2
    assert "End of training." in log
    ckpt = {p.name for p in (exp / "checkpoint").iterdir()}
    assert ckpt == {"I3_E1_gen.pth", "I3_E1_opt.pth"}
    results = {p.name for p in (exp / "results" / "1").iterdir()}
    assert {f"2_{i}_{tag}.png" for i in (1, 2, 3)
            for tag in ("sr", "hr", "lr", "inf")} <= results


def test_train_cli_64_512_on_the_ports_dataset(tmp_path):
    """``python -m sr3_tpu_torch.sr -p train`` on the 64->512 fixtures
    through the port's own dataset: 2 steps of a tiny remat UNet at 512^2
    (its top-level dropout Blocks take the GroupNorm statistics route), a
    validation and a checkpoint at step 2. Five levels put the mid block's
    attention at 32x32: at fewer, the plain attention of the CPU would
    materialize a (H*W)^2 matrix of tens of GB."""
    opt = _config()
    opt["phase"] = "train"
    data = {"name": "FIX512", "dataroot": FIXTURES_512, "datatype": "img",
            "l_resolution": 64, "r_resolution": 512}
    opt["datasets"] = {
        "train": dict(data, mode="HR", batch_size=2, num_workers=0,
                      use_shuffle=True, data_len=-1),
        "val": dict(data, mode="LRHR", data_len=1),
    }
    opt["model"]["unet"].update(inner_channel=8,
                                channel_multiplier=[1, 2, 4, 8, 8],
                                attn_res=[], dropout=0.2, remat=True)
    opt["model"]["diffusion"]["image_size"] = 512
    opt["train"].update(n_iter=2, val_freq=2, save_checkpoint_freq=2,
                        print_freq=1)
    cfg = tmp_path / "port512.json"
    cfg.write_text(json.dumps(opt))
    _run(["-m", "sr3_tpu_torch.sr", "-p", "train", "-c", str(cfg)], tmp_path)
    (exp,) = (tmp_path / "experiments").iterdir()
    log = (exp / "logs" / "train.log").read_text()
    losses = [float(line.split("l_pix: ")[1].split()[0])
              for line in log.splitlines() if "l_pix: " in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert "Dataset [LRHRDataset - FIX512] is created." in log
    assert log.count("# Validation # PSNR: ") == 1
    assert {p.name for p in (exp / "checkpoint").iterdir()} == {
        "I2_E1_gen.pth", "I2_E1_opt.pth"}
    # -p train keeps 3 val images
    results = {p.name for p in (exp / "results" / "1").iterdir()}
    assert {f"2_{i}_{tag}.png" for i in (1, 2, 3)
            for tag in ("sr", "hr", "lr", "inf")} == results


def _sr3_tpu_imports(path):
    """Names of the sr3_tpu modules that a source file imports, at top
    level or inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    return {m for m in names if m.split(".")[0] == "sr3_tpu"}


def test_port_imports_no_jax(tmp_path):
    script = textwrap.dedent(f"""
        import importlib, json, os, pkgutil, sys
        import numpy as np
        import sr3_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            sr3_tpu_torch.__path__, "sr3_tpu_torch.")]
        assert {{"sr3_tpu_torch.sample", "sr3_tpu_torch.eval",
                 "sr3_tpu_torch.cascade", "sr3_tpu_torch.data.prepare",
                 "sr3_tpu_torch.training.cascade",
                 "sr3_tpu_torch.training.optim",
                 "sr3_tpu_torch.parallel.mesh",
                 "sr3_tpu_torch.parallel.spatial",
                 "sr3_tpu_torch.parallel.sharding_rules"}} <= set(names)
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        from sr3_tpu_torch.data.loader import DataLoader
        from sr3_tpu_torch.training.evaluation import GroupedEvaluator
        from sr3_tpu_torch.training.loops import train_loop
        from sr3_tpu_torch.training.trainer import create_model
        opt = json.loads({json.dumps(_config())!r})
        opt["model"]["diffusion"]["image_size"] = 16
        opt["model"]["unet"]["attn_res"] = [8]
        trainer = create_model(opt)
        trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                       "val")
        item = {{"SR": np.zeros((16, 16, 3), np.float32)}}
        (_, frames), = GroupedEvaluator(trainer, 1).run_sr([item], True)
        assert frames.shape == (11, 16, 16, 3) and np.isfinite(frames).all()
        uncond = json.loads(json.dumps(opt))
        uncond["model"]["which_model_G"] = "ddpm"
        uncond["model"]["unet"]["in_channel"] = 3
        uncond["model"]["diffusion"].update(conditional=False,
                                            sampler="dpm++", sampler_steps=3)
        sampler = create_model(uncond)
        sampler.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                       "val")
        (sample,) = GroupedEvaluator(sampler, 1).run_uncond(1)
        assert sample.shape == (16, 16, 3) and np.isfinite(sample).all()
        opt["phase"] = "train"
        opt["path"]["checkpoint"] = "."
        opt["model"]["unet"]["dropout"] = 0.2
        trainer = create_model(opt)
        trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"])
        data = [{{"HR": np.zeros((16, 16, 3), np.float32),
                  "SR": np.zeros((16, 16, 3), np.float32)}}] * 2
        train_loop(trainer, DataLoader(data, 2), opt, lambda s, e: None)
        assert trainer.step == 4 and os.path.isfile("I4_E4_gen.pth")
        from sr3_tpu_torch.data.prepare import resize_and_convert
        from sr3_tpu_torch.training.cascade import to_condition
        assert resize_and_convert(np.zeros((20, 30, 3), np.uint8),
                                  8).shape == (8, 8, 3)
        assert to_condition(np.zeros((8, 8, 3)), 16).shape == (16, 16, 3)
        opt["train"]["optimizer"]["mu_dtype"] = "bfloat16"
        opt["datasets"]["train"]["device_data"] = True
        opt["train"]["n_iter"] = 2
        trainer = create_model(opt)
        trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["train"])
        uint8 = [{{"HR": np.zeros((16, 16, 3), np.uint8),
                   "SR": np.zeros((16, 16, 3), np.uint8)}}] * 2

        class Decoded(list):
            def _decoded(self, i):
                return self[i]

        train_loop(trainer, DataLoader(Decoded(uint8), 2), opt,
                   lambda s, e: None)
        assert trainer.step == 2
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                         "orbax", "sr3_tpu")]
        assert not loaded, loaded
        print("modules", len(names))
    """)
    proc = _run(["-c", script], tmp_path)
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 17
    # no module of the port and not chip_smoke.py imports the JAX package,
    # not even its numpy-only host modules
    sources = [os.path.join(root, f)
               for root, _, files in os.walk(os.path.join(REPO,
                                                          "sr3_tpu_torch"))
               for f in files if f.endswith(".py")]
    assert len(sources) >= n
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    foreign = {os.path.relpath(p, REPO): _sr3_tpu_imports(p) for p in sources}
    assert not any(foreign.values()), foreign
    # chip_smoke.py names only the port: the JAX package's host code it
    # needs comes in through the port's own modules
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = {a.name for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    foreign = {m for m in imported
               if m.split(".")[0] in ("sr3_tpu", "jax", "flax")}
    assert not foreign, foreign
    assert "sr3_tpu_torch.ops" in imported


def test_chip_smoke_refuses_without_cuda(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is false" in proc.stderr
