"""The port's evaluation CLIs as real subprocesses on the CPU: ``sr -p val``
against the root sr.py's evaluate_sr and against rescoring its own PNGs,
``sample -p train`` then ``sample -p val``, and the port's offline scorer
against the root eval.py."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

from test_torch_port_driver import REPO, _config, _run


def _log(exp):
    return (exp / "logs" / "train.log").read_text()


def _summary(text):
    """(PSNR, SSIM) strings of the '# Validation #' summary lines."""
    vals = {line.split("# Validation # ")[1].split(":")[0]:
            line.rsplit(": ", 1)[1].strip()
            for line in text.splitlines() if "# Validation # " in line}
    return vals["PSNR"], vals["SSIM"]


def _checkpoint(opt, prefix):
    """A port _gen.pth of opt's model at ``prefix`` (seeded random
    weights) for ``path.resume_state``."""
    from sr3_tpu_torch.models.networks import define_G

    net = define_G(opt, device="cpu", seed=3).denoise_fn
    torch.save(net.state_dict(), f"{prefix}_gen.pth")


def test_sr_val_cli_writes_the_root_sr_files_and_scores(tmp_path):
    """``python -m sr3_tpu_torch.sr -p val`` from a resume state: the same
    result files as the root sr.py's -p val (the JAX evaluate_sr) on the
    same config, and PSNR / SSIM equal to rescoring its PNGs with the
    port's eval.py."""
    opt = _config()
    _checkpoint(opt, tmp_path / "I7_E2")
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    port_opt = copy.deepcopy(opt)
    port_opt["path"]["resume_state"] = str(tmp_path / "I7_E2")
    (port / "val.json").write_text(json.dumps(port_opt))
    (jax_dir / "val.json").write_text(json.dumps(opt))
    _run(["-m", "sr3_tpu_torch.sr", "-p", "val", "-c", "val.json"], port)
    _run([os.path.join(REPO, "sr.py"), "-p", "val", "-c", "val.json"],
         jax_dir)
    (exp,) = (port / "experiments").iterdir()
    (jexp,) = (jax_dir / "experiments").iterdir()
    files = {p.name for p in (exp / "results").iterdir()}
    assert files == {p.name for p in (jexp / "results").iterdir()}
    assert files == {f"0_{i}_{tag}.png" for i in (1, 2)
                     for tag in ("sr_process", "sr", "hr", "lr", "inf")}
    log = _log(exp)
    assert "Loading pretrained model for G" in log
    assert "UNet(cond_mode=sr3)" in log and "End of Model Evaluation." in log
    out = tmp_path / "scores.json"
    proc = _run(["-m", "sr3_tpu_torch.eval", "-p", str(exp / "results"),
                 "--json", str(out)], tmp_path)
    scores = json.loads(out.read_text())
    assert scores["count"] == 2
    assert _summary(log) == _summary(proc.stdout) == (
        f"{scores['avg_psnr']:.4e}", f"{scores['avg_ssim']:.4e}")


def test_sample_cli_trains_then_evaluates(tmp_path):
    """``python -m sr3_tpu_torch.sample``: -p train on an unconditional
    ddpm model (2 steps, sampling at step 2 with DDIM, a checkpoint), then
    -p val from that checkpoint with the SDE DPM++: sample and process
    PNGs of every val item."""
    opt = _config()
    opt["phase"] = "train"
    opt["model"]["which_model_G"] = "ddpm"
    opt["model"]["unet"].update(in_channel=3, dropout=0.2)
    opt["model"]["diffusion"].update(conditional=False, sampler="ddim",
                                     sampler_steps=4)
    opt["train"].update(n_iter=2, val_freq=2, save_checkpoint_freq=2)
    (tmp_path / "train.json").write_text(json.dumps(opt))
    _run(["-m", "sr3_tpu_torch.sample", "-p", "train", "-c", "train.json"],
         tmp_path)
    (exp,) = (tmp_path / "experiments").iterdir()
    log = _log(exp)
    assert "UNet(cond_mode=ddpm)" in log and "End of training." in log
    # -p train keeps 3 val items: 3 samples
    assert {p.name for p in (exp / "results" / "1").iterdir()} == {
        f"2_{i}_sample.png" for i in (1, 2, 3)}

    opt["phase"] = "val"
    opt["path"]["resume_state"] = str(exp / "checkpoint" / "I2_E1")
    opt["model"]["diffusion"].update(sampler="dpm++", eta=1.0)
    val_dir = tmp_path / "val"
    val_dir.mkdir()
    (val_dir / "val.json").write_text(json.dumps(opt))
    _run(["-m", "sr3_tpu_torch.sample", "-p", "val", "-c", "val.json"],
         val_dir)
    (vexp,) = (val_dir / "experiments").iterdir()
    assert "End of Model Evaluation." in _log(vexp)
    assert {p.name for p in (vexp / "results").iterdir()} == {
        f"0_{i}_{tag}.png" for i in (1, 2)
        for tag in ("sample", "sample_process")}


def test_port_eval_gives_the_root_evals_json(tmp_path):
    """One directory of PNG pairs (and an unmatched output): the port's
    eval.py and the root eval.py print the same summary and write the same
    JSON."""
    from PIL import Image

    rng = np.random.default_rng(9)
    results = tmp_path / "results"
    results.mkdir()
    for stem in ("3_1", "3_2", "4_1"):
        hr = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        noise = rng.integers(-20, 21, hr.shape)
        sr = np.clip(hr.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(hr).save(results / f"{stem}_hr.png")
        Image.fromarray(sr).save(results / f"{stem}_sr.png")
    Image.fromarray(sr).save(results / "9_9_sr.png")  # no ground truth
    outs = {}
    for name, args in (("port", ["-m", "sr3_tpu_torch.eval"]),
                       ("root", [os.path.join(REPO, "eval.py")])):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run(
            [sys.executable, *args, "-p", str(results), "--per-image",
             "--json", str(out)], cwd=REPO, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[name] = (proc.stdout.replace(str(out), "OUT"),
                      json.loads(out.read_text()))
    assert outs["port"] == outs["root"]
    assert outs["port"][1]["count"] == 3
    assert "1 generated image(s) have no _hr counterpart" in outs["port"][0]
