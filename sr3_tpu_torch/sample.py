"""Unconditional-generation train / val entry point of the port,
CLI-compatible with the root sample.py.

  python -m sr3_tpu_torch.sample -p train -c configs/sample_sr3_128.json
  python -m sr3_tpu_torch.sample -p val -c <config with path.resume_state>

The sample count is the val set's length (reference sample.py:64). ``-p
train`` runs ``train_loop`` with ``sample_in_train`` (one PNG per sample,
val schedule) every ``train.val_freq`` steps; ``-p val`` runs
``evaluate_uncond``: the process grid and the final sample of each draw.
``model.diffusion.sampler`` picks the chain (ancestral, DDIM or
DPM-Solver++). The device is CUDA; ``SR3_PLATFORM=cpu`` runs it on the CPU.

Several ranks: ``torchrun --nproc_per_node N -m sr3_tpu_torch.sample ...``
with a config ``"parallel": {"data": D, "model": M, "space": S}`` block,
D * M * S = N (``sr3_tpu_torch/parallel/mesh.py``; ``--dist-backend``,
default nccl on CUDA, gloo on the CPU); only the primary rank writes.
"""

from __future__ import annotations

import argparse
import itertools
import logging

import sr3_tpu_torch.utils.config as Config
from sr3_tpu_torch.data.loader import create_dataloader, create_dataset
from sr3_tpu_torch.parallel.mesh import (add_dist_argument, finish,
                                         is_primary, start)
from sr3_tpu_torch.training.evaluation import evaluate_uncond, sample_in_train
from sr3_tpu_torch.training.loops import train_loop
from sr3_tpu_torch.training.trainer import create_model


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str,
                        default="configs/sample_sr3_128.json")
    parser.add_argument("-p", "--phase", type=str, choices=["train", "val"],
                        default="train")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)
    parser.add_argument("-debug", "-d", action="store_true")
    add_dist_argument(parser)
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_wandb_ckpt", action="store_true")
    parser.add_argument("-log_eval", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mesh = start(args, Config.load_json_with_comments(args.config)
                 .get("parallel"))
    run(args, mesh)
    finish(mesh)


def run(args, mesh):
    opt = Config.dict_to_nonedict(Config.parse(args))
    primary = is_primary(mesh)
    if primary:  # the other ranks log nothing
        Config.setup_logger(None, opt["path"]["log"], "train", screen=True)
        Config.setup_logger("val", opt["path"]["log"], "val")
    logger = logging.getLogger("base")
    logger.info(Config.dict2str(opt))

    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    tb_logger = (SummaryWriter(log_dir=opt["path"]["tb_logger"])
                 if SummaryWriter and primary else None)
    wandb_logger = None
    if opt["enable_wandb"] and primary:
        from sr3_tpu_torch.utils.wandb_logger import WandbLogger

        wandb_logger = WandbLogger(opt)

    if opt["phase"] == "train":
        train_set = create_dataset(opt["datasets"]["train"], "train")
        train_loader = create_dataloader(train_set, opt["datasets"]["train"],
                                         "train", mesh)
    sample_sum = len(create_dataset(opt["datasets"]["val"], "val"))
    logger.info("Initial Dataset Finished")

    trainer = create_model(opt, mesh=mesh)
    trainer.print_network()
    logger.info("Initial Model Finished")
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"][opt["phase"]],
                                   schedule_phase=opt["phase"])
    if opt["phase"] == "val":
        logger.info("Begin Model Evaluation.")
        evaluate_uncond(trainer, sample_sum, opt,
                        current_step=trainer.begin_step,
                        wandb_logger=wandb_logger)
        logger.info("End of Model Evaluation.")
        return

    val_counter = itertools.count()

    def on_validate(current_step, current_epoch):
        sample_in_train(trainer, sample_sum, opt, current_step, current_epoch,
                        wandb_logger=wandb_logger)
        if wandb_logger:
            wandb_logger.log_metrics({"validation/val_step": next(val_counter)})

    train_loop(trainer, train_loader, opt, on_validate, tb_logger=tb_logger,
               wandb_logger=wandb_logger)


if __name__ == "__main__":
    main()
