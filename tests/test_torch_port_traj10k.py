"""``python -m sr3_tpu_torch.traj10k`` end to end on the CPU at a tiny size.

The module's constants are patched to a tiny sr3 model over the bundled
16->128 fixtures (T=4, 4 resident steps, EMA from step 0) and to two small
sampler evaluations; the run happens in a scratch directory. It must train,
checkpoint, write the trajectory record with its header, and write the
sampler record (the first evaluation) and its witness (the others, one
artifact a key).
"""

import json
import os
import sys

import pytest

from sr3_tpu_torch import traj10k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = {"schedule": "linear", "n_timestep": 4, "linear_start": 1e-6,
         "linear_end": 1e-2}


def _config():
    data = {"name": "FIX", "dataroot": os.path.join(REPO, "dataset",
                                                    "fixtures_16_128"),
            "datatype": "img", "l_resolution": 16, "r_resolution": 128}
    return {
        "name": "traj_tiny", "phase": "train", "gpu_ids": [0],
        "path": {"log": "logs", "tb_logger": "tb_logger",
                 "results": "results", "checkpoint": "checkpoint",
                 "resume_state": None},
        "datasets": {
            "train": dict(data, mode="HR", batch_size=2, device_data=True,
                          num_workers=0, use_shuffle=True, data_len=-1),
            "val": dict(data, mode="LRHR", data_len=2),
        },
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": 128, "channels": 3,
                          "conditional": True},
        },
        "train": {"n_iter": 100000, "steps_per_dispatch": 2, "val_freq": 4,
                  "save_checkpoint_freq": 50000, "print_freq": 2,
                  "optimizer": {"type": "adam", "lr": 1e-4},
                  "ema_scheduler": {"step_start_ema": 0,
                                    "update_ema_every": 1,
                                    "ema_decay": 0.9, "use_ema": True}},
        "wandb": {"project": "traj_tiny"},
    }


def test_traj10k_trains_scores_and_writes_its_records(tmp_path, monkeypatch):
    cfg = tmp_path / "traj_tiny.json"
    cfg.write_text(json.dumps(_config()))
    monkeypatch.setattr(traj10k, "ROOT", str(tmp_path))
    monkeypatch.setattr(traj10k, "CONFIG", str(cfg))
    monkeypatch.setattr(traj10k, "N_ITER", 4)
    monkeypatch.setattr(traj10k, "TRAIN_TIMEOUT", 600)
    monkeypatch.setattr(traj10k, "REPS", 2)
    monkeypatch.setattr(traj10k, "EVALS", [
        ("float32_T4", "float32", 4, ["ddpm:4", "ddim:2", "dpm++:2"]),
        ("float32_T2", "float32", 2, ["ddpm:2"])])
    for key, value in (("SR3_PLATFORM", "cpu"), ("PYTHONPATH", REPO),
                       ("OMP_NUM_THREADS", "2")):
        monkeypatch.setenv(key, value)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", ["traj10k", "--out", str(out)])
    assert traj10k.main() == 0

    (exp,) = (tmp_path / "experiments").iterdir()
    assert {p.name for p in (exp / "checkpoint").iterdir()} >= {
        "I4_E2_gen.pth", "I4_E2_opt.pth"}
    traj = json.loads((out / "TORCH_TRAJ10K.json").read_text())
    assert {"config", "script", "card", "train_seconds", "note"} <= set(traj)
    assert traj["config"].endswith(
        "with train.n_iter 4 and train.save_checkpoint_freq 4 "
        "(written at run time)")
    # the first print point has no step time yet, so traj_extract skips it
    assert [p["iter"] for p in traj["loss"]] == [4]
    assert [v["iter"] for v in traj["val"]] == [4]

    record = json.loads((out / "TORCH_SAMPLER_EVAL_10K.json").read_text())
    assert record["val_timesteps"] == 4
    assert [r["sampler"] for r in record["results"]] == [
        "ddpm:4", "ddim:2", "dpm++:2"]
    assert "model.dtype float32" in record["config"]
    witness = json.loads(
        (out / "TORCH_SAMPLER_EVAL_10K_WITNESS.json").read_text())
    assert set(witness) == {"script", "card", "float32_T2"}
    assert witness["float32_T2"]["val_timesteps"] == 2
    (row,) = witness["float32_T2"]["results"]
    # 6 fixture images (data_len -1), REPS chains each
    assert row["nfe"] == 2 and len(row["psnr_db"]) == 6
    assert all(len(per_img) == 2 for per_img in row["psnr_db"])


def test_traj10k_takes_only_out_and_precheck(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["traj10k", "--n-iter", "4"])
    with pytest.raises(SystemExit):
        traj10k.main()
