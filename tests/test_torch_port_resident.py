"""The port's device-resident dataset (datasets.train.device_data) against
the JAX package's, on the CPU.

- The batch built from given indices and flips equals, exactly, the batch
  that the JAX trainer's resident step samples with the same draws (its own
  jax.random draws, reproduced here from its step key).
- One resident step of the tiny sr3 UNet (carried weights, the same batch,
  injected noise and sqrt-gamma, no dropout) gives the JAX step's loss
  within 1e-5.
- The draws: a permutation slice when batch <= n <= 4096, with replacement
  otherwise; a function of (seed, step) only.
- train_loop with device_data on dataset/fixtures_16_128; a run stopped at
  step 4 and resumed from its checkpoint ends with the parameters of one
  run straight through (bit for bit).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from sr3_tpu.parallel.mesh import create_mesh
from sr3_tpu.training.trainer import Trainer as JaxTrainer
from sr3_tpu.utils.config import dict_to_nonedict
from sr3_tpu_torch.data.loader import create_dataloader, create_dataset
from sr3_tpu_torch.training.loops import train_loop
from sr3_tpu_torch.training.trainer import create_model
from sr3_tpu_torch.utils.torch_compat import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "dataset", "fixtures_16_128")
SCHED = {"schedule": "linear", "n_timestep": 10, "linear_start": 1e-6,
         "linear_end": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opt(tmp_path, image=16, dropout=0.0, n_iter=4, resume_state=None):
    return {
        "name": "resident", "phase": "train", "seed": 3,
        "path": {"checkpoint": str(tmp_path), "resume_state": resume_state},
        "datasets": {"train": {
            "name": "FIX", "mode": "HR", "dataroot": FIXTURES,
            "datatype": "img", "l_resolution": 16, "r_resolution": 128,
            "batch_size": 2, "use_shuffle": True, "data_len": -1,
            "device_data": True}},
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "dtype": "float32",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8,
                     "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [], "res_blocks": 1, "dropout": dropout},
            "beta_schedule": {"train": dict(SCHED), "val": dict(SCHED)},
            "diffusion": {"image_size": image, "channels": 3,
                          "conditional": True},
        },
        "train": {"n_iter": n_iter, "val_freq": 10 ** 9,
                  "save_checkpoint_freq": 4, "print_freq": 1,
                  "steps_per_dispatch": 2,
                  "optimizer": {"type": "adam", "lr": 1e-3}},
    }


class Tiny:
    """Five seeded uint8 (HR, SR) pairs, as LRHRDataset._decoded gives."""
    min_max = (-1, 1)

    def __len__(self):
        return 5

    def _decoded(self, i):
        rng = np.random.default_rng(i)
        return {k: rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                for k in ("HR", "SR")}


def _jax_step_draws(jt, step, n, b):
    """The JAX resident step's sample indices and flips at ``step``,
    reproduced from its base key (trainer.py _build_resident_steps)."""
    rng = jax.random.fold_in(jt._train_base_rng, step)
    k_batch, _ = jax.random.split(rng)
    kidx, kflip = jax.random.split(k_batch)
    idx = jax.random.permutation(kidx, n)[:b]
    flip = jax.random.bernoulli(kflip, 0.5, (b,))
    return np.asarray(idx), np.asarray(flip)


def test_resident_batch_and_step_match_the_jax_trainer(tmp_path, monkeypatch):
    """The JAX resident step (its sampled batch read by a debug callback)
    and the port's: the batch from the JAX draws equal bit for bit, the loss
    on injected noise and sqrt-gamma within 1e-5."""
    b, n = 4, len(Tiny())
    opt = _opt(tmp_path)
    jt = JaxTrainer(dict_to_nonedict(opt), mesh=create_mesh(num_data=1))
    jt.set_new_noise_schedule(SCHED, "train")
    jt.load_device_dataset(Tiny())
    jt.rng, jt._train_base_rng = jax.random.split(jt.rng)
    rng = np.random.default_rng(60)
    inj = {"noise": rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
           "sqrt_gamma": rng.uniform(0.9, 0.99, (b, 1)).astype(np.float32)}
    seen = {}
    jax_losses = jt.diffusion.p_losses

    def capture(params, sched, batch, key, train=True):
        jax.debug.callback(lambda bt: seen.update(
            {k: np.asarray(v) for k, v in bt.items()}), batch)
        return jax_losses(params, sched, batch, key, train=train,
                          injected=inj)

    monkeypatch.setattr(jt.diffusion, "p_losses", capture)
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    fn = jt._build_resident_steps(b, 1)  # donates the state
    _, jax_loss = fn(jt.state, jt.sched, jt._dev_data, jt._train_base_rng)
    jax.effects_barrier()
    idx, flip = _jax_step_draws(jt, 0, n, b)
    assert flip.any() and not flip.all()  # both branches of the flip

    port = create_model(opt, device="cpu")
    load_flax_params(port.netG, params)
    port.set_new_noise_schedule(SCHED)
    assert port.load_device_dataset(Tiny()) == 2 * n * 16 * 16 * 3
    got = port.sample_resident_batch(torch.from_numpy(idx),
                                     torch.from_numpy(flip))
    for k in ("HR", "SR"):
        nhwc = got[k].permute(0, 2, 3, 1).numpy()
        assert np.array_equal(nhwc, seen[k]), k
        assert got[k].is_contiguous(memory_format=torch.channels_last)

    monkeypatch.setattr(port, "_resident_draws",
                        lambda g, bs: (torch.from_numpy(idx),
                                       torch.from_numpy(flip)))
    monkeypatch.setattr(port.diffusion, "p_losses", functools.partial(
        port.diffusion.p_losses, injected={
            "noise": torch.from_numpy(inj["noise"]).permute(0, 3, 1, 2),
            "sqrt_gamma": torch.from_numpy(inj["sqrt_gamma"])}))
    port.optimize_parameters_resident(b, 1)
    assert port.step == 1
    np.testing.assert_allclose(port.get_current_log()["l_pix"],
                               float(jax_loss), rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,replace", [(4, False), (7, True)])
def test_resident_draws(tmp_path, b, replace):
    """A permutation slice (distinct samples) when the batch fits the set,
    else with replacement; the same (seed, step) draws the same batch."""
    trainer = create_model(_opt(tmp_path), device="cpu")
    trainer.load_device_dataset(Tiny())
    seen = set()
    for step in range(6):
        g = torch.Generator().manual_seed(1000 + step)
        idx, flip = trainer._resident_draws(g, b)
        assert idx.shape == (b,) and flip.dtype == torch.bool
        assert int(idx.min()) >= 0 and int(idx.max()) < 5
        if not replace:
            assert len(set(idx.tolist())) == b
        seen.add(tuple(idx.tolist()))
        g.manual_seed(1000 + step)
        again, flip2 = trainer._resident_draws(g, b)
        assert torch.equal(idx, again) and torch.equal(flip, flip2)
    assert len(seen) > 1
    if replace:
        assert any(len(set(s)) < len(s) for s in seen)


def test_resident_set_keys_scale_and_dtype(tmp_path):
    """A set of stacked uint8 arrays behind ``_decoded`` (as the card's
    machine, which decodes no PNG, gives one) goes to the device as it is;
    the batch is x * (2 / 255) - 1, flipped where asked; an unconditional
    trainer keeps HR only; other dtypes are refused."""
    rng = np.random.default_rng(61)
    arrays = {k: rng.integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
              for k in ("HR", "SR")}

    class Arrays:
        def __init__(self, arrays):
            self.arrays = arrays

        def __len__(self):
            return len(self.arrays["HR"])

        def _decoded(self, i):
            return {k: v[i] for k, v in self.arrays.items()}

    trainer = create_model(_opt(tmp_path), device="cpu")
    assert trainer.load_device_dataset(Arrays(arrays)) == \
        2 * arrays["HR"].nbytes
    batch = trainer.sample_resident_batch(torch.tensor([2, 0]),
                                          torch.tensor([False, True]))
    want = arrays["SR"][[2, 0]].astype(np.float32) * np.float32(2 / 255) - 1
    want[1] = want[1, :, ::-1]
    np.testing.assert_allclose(batch["SR"].permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)
    opt = _opt(tmp_path)
    opt["model"]["unet"]["in_channel"] = 3
    opt["model"]["diffusion"]["conditional"] = False
    uncond = create_model(opt, device="cpu")
    uncond.load_device_dataset(Arrays(arrays))
    assert sorted(uncond._dev_data) == ["HR"]
    with pytest.raises(ValueError, match="uint8"):
        trainer.load_device_dataset(Arrays(
            {k: v.astype(np.float32) for k, v in arrays.items()}))


def _fixture_run(tmp_path, n_iter, resume_state=None):
    os.makedirs(tmp_path, exist_ok=True)
    opt = _opt(tmp_path, image=128, dropout=0.2, n_iter=n_iter,
               resume_state=resume_state)
    dataset = create_dataset(opt["datasets"]["train"], "train")
    loader = create_dataloader(dataset, opt["datasets"]["train"], "train")
    trainer = create_model(opt, device="cpu")
    trainer.set_new_noise_schedule(SCHED)
    losses = []
    step = trainer.optimize_parameters_resident

    def logged(bs, k):
        step(bs, k)
        losses.append(trainer.get_current_log()["l_pix"])

    trainer.optimize_parameters_resident = logged
    train_loop(trainer, loader, opt, lambda s, e: None)
    return trainer, losses


def test_train_loop_device_data_resumes_as_one_run(tmp_path):
    """The fixture set resident on the device, K = 2 steps a call: 6 steps
    straight, and 4 steps, a checkpoint, then a resumed run to 6, end with
    equal parameters; the host loader never runs."""
    straight, losses = _fixture_run(tmp_path / "a", 6)
    assert straight.step == 6 and len(losses) == 3
    assert all(np.isfinite(losses))
    assert straight._dev_data["HR"].dtype == torch.uint8
    assert tuple(straight._dev_data["HR"].shape) == (6, 128, 128, 3)
    first, _ = _fixture_run(tmp_path / "b", 4)
    assert os.path.isfile(tmp_path / "b" / "I4_E2_opt.pth")
    resumed, _ = _fixture_run(tmp_path / "b", 6,
                              resume_state=str(tmp_path / "b" / "I4_E2"))
    assert resumed.begin_step == 4 and resumed.step == 6
    moved = False
    for (name, p), q, r in zip(straight.netG.named_parameters(),
                               resumed.netG.parameters(),
                               first.netG.parameters()):
        assert torch.equal(p, q), name
        moved |= not torch.equal(p, r)
    assert moved
