"""The port's mesh and its per-rank data: ``parallel/mesh.py`` and the
loader's shard, on the CPU.

A config's ``parallel`` block gives the mesh coordinates (4 gloo ranks,
data 2 x space 2); a product other than the world size raises, and so does
a block of more than one rank in a single process; the train loader's
shards are disjoint, cover every whole global batch of the epoch, and
give the ranks that share a data coordinate (model and space peers) the
same indices in the same order; the val loader is batch 1, unshuffled and
unsharded. Last, ``python -m sr3_tpu_torch.sr -p train`` runs under 2 ranks
with ``"parallel": {"data": 2}``: one experiment directory, the primary's
log, one checkpoint.
"""

import json
import os

import numpy as np
import pytest

from sr3_tpu_torch.data.loader import DataLoader, create_dataloader
from sr3_tpu_torch.parallel.mesh import (data_slice, init_mesh,
                                         parallel_shape, shard_batch)
from tests.torch_port_parallel_common import ROOT, run_ranks, torchrun


def test_no_parallel_block_in_one_process_is_the_single_device_path():
    assert init_mesh(None) is None
    assert init_mesh({"data": 1, "model": 1, "space": 1}) is None


@pytest.mark.parametrize("block", [{"data": 2}, {"space": 4},
                                   {"data": 2, "model": 2}])
def test_a_parallel_block_in_one_process_raises(block):
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        init_mesh(block)


def test_a_product_other_than_the_world_size_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match=r"needs 2 ranks .* WORLD_SIZE is 4"):
        init_mesh({"data": 2})
    with pytest.raises(ValueError, match="unknown axes"):
        parallel_shape({"pipeline": 2})


def test_the_parallel_block_gives_the_mesh_coordinates(tmp_path):
    ranks = run_ranks(str(tmp_path), 4, {"parallel": {"data": 2, "space": 2},
                                         "cases": ["mesh"]})
    assert [r["mesh"]["coords"] for r in ranks] == [
        (0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    assert [r["mesh"]["primary"] for r in ranks] == [True, False, False,
                                                     False]
    assert ranks[3]["mesh"]["shape"] == {"data": 2, "model": 1, "space": 2}


def _epoch(n, batch, coord, size, seed=3):
    loader = DataLoader(list(range(n)), batch_size=batch, shuffle=True,
                        drop_last=True, seed=seed, shard=(coord, size))
    return [list(map(int, b)) for b in loader.indices()]


@pytest.mark.parametrize("n,batch,size", [(13, 4, 2), (20, 6, 3), (9, 4, 4)])
def test_data_shards_are_disjoint_and_cover_each_global_batch(n, batch, size):
    one = _epoch(n, batch, 0, 1)
    shards = [_epoch(n, batch, c, size) for c in range(size)]
    assert all(len(s) == len(one) == n // batch for s in shards)
    for step, global_batch in enumerate(one):
        parts = [s[step] for s in shards]
        assert all(len(p) == batch // size for p in parts)
        assert sorted(sum(parts, [])) == sorted(global_batch)
    flat = sum((sum(s, []) for s in shards), [])
    assert len(flat) == len(set(flat))


def test_model_and_space_peers_read_the_same_indices():
    # a rank's indices depend on its data coordinate alone, and every rank
    # shuffles from the same seed
    assert _epoch(17, 4, 1, 2) == _epoch(17, 4, 1, 2)
    assert _epoch(17, 4, 0, 2) != _epoch(17, 4, 1, 2)
    two = DataLoader(list(range(17)), 4, True, True, seed=3, shard=(1, 2))
    assert [list(b) for b in two.indices()] != [list(b) for b in
                                                two.indices()]


def test_the_val_loader_is_batch_one_unshuffled_and_unsharded():
    items = [{"x": np.full((2, 2, 3), i, np.float32)} for i in range(5)]
    loader = create_dataloader(items, {"batch_size": 4, "use_shuffle": True},
                               "val")
    got = [b["x"] for b in loader]
    assert len(got) == 5 and all(b.shape == (1, 2, 2, 3) for b in got)
    assert [float(b[0, 0, 0, 0]) for b in got] == [0, 1, 2, 3, 4]
    with pytest.raises(NotImplementedError):
        create_dataloader(items, {}, "test")


def test_shard_batch_replicates_a_batch_the_data_axis_does_not_divide():
    class M:
        data = type("A", (), {"size": 2, "rank": 1})()
    assert data_slice(4, M) == slice(2, 4)
    assert data_slice(3, M) == slice(0, 3)
    out = shard_batch({"HR": np.arange(6).reshape(3, 2), "path": "p"}, M)
    np.testing.assert_array_equal(out["HR"], np.arange(6).reshape(3, 2))
    assert out["path"] == "p"


def test_train_cli_under_two_data_ranks(tmp_path):
    fixtures = os.path.join(ROOT, "dataset", "fixtures_16_128")
    sched = {"schedule": "linear", "n_timestep": 4, "linear_start": 1e-6,
             "linear_end": 1e-2}
    data = {"name": "FIX", "dataroot": fixtures, "datatype": "img",
            "l_resolution": 16, "r_resolution": 128}
    opt = {
        "name": "port", "phase": "train", "parallel": {"data": 2},
        "path": {"log": "logs", "tb_logger": "tb_logger",
                 "results": "results", "checkpoint": "checkpoint",
                 "resume_state": None},
        "datasets": {
            "train": dict(data, mode="HR", batch_size=2, num_workers=0,
                          use_shuffle=True, data_len=-1),
            "val": dict(data, mode="LRHR", data_len=2)},
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": 0.2},
            "beta_schedule": {"train": sched, "val": sched},
            "diffusion": {"image_size": 128, "channels": 3,
                          "conditional": True}},
        "train": {"n_iter": 2, "val_freq": 2, "save_checkpoint_freq": 2,
                  "print_freq": 1, "optimizer": {"type": "adam",
                                                 "lr": 1e-4}},
        "wandb": {"project": "port"},
    }
    cfg = tmp_path / "port.json"
    cfg.write_text(json.dumps(opt))
    env = {"SR3_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT}
    rc, out = torchrun(["-m", "sr3_tpu_torch.sr", "-p", "train", "-c",
                        str(cfg), "--dist-backend", "gloo"], 2, env=env,
                       timeout=300, cwd=str(tmp_path))
    assert rc == 0, out[-6000:]
    (exp,) = (tmp_path / "experiments").iterdir()
    log = (exp / "logs" / "train.log").read_text()
    assert log.count("l_pix: ") == 2 and "End of training." in log
    assert log.count("# Validation # PSNR: ") == 1
    assert {p.name for p in (exp / "checkpoint").iterdir()} == {
        "I2_E1_gen.pth", "I2_E1_opt.pth"}
    assert {f"2_{i}_{tag}.png" for i in (1, 2) for tag in
            ("sr", "hr", "lr", "inf")} <= {
        p.name for p in (exp / "results" / "1").iterdir()}
