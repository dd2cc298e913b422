"""Inference-only entry point of the port, CLI-compatible with the root
infer.py.

  python -m sr3_tpu_torch.infer -c configs/sr_sr3_16_128.json

Builds the val dataset, the model (weights from ``path.resume_state``'s
``_gen.pth`` when set) and runs grouped SR inference with process-grid
outputs (``sr3_tpu_torch.training.evaluation.infer_sr``). The device is CUDA;
``SR3_PLATFORM=cpu`` runs it on the CPU.

Several ranks: ``torchrun --nproc_per_node N -m sr3_tpu_torch.infer ...``
with a config ``"parallel": {"data": D, "model": M, "space": S}`` block,
D * M * S = N (``sr3_tpu_torch/parallel/mesh.py``; ``--dist-backend``,
default nccl on CUDA, gloo on the CPU); only the primary rank writes.
"""

from __future__ import annotations

import argparse
import logging

import sr3_tpu_torch.utils.config as Config
from sr3_tpu_torch.data.loader import create_dataset
from sr3_tpu_torch.parallel.mesh import (add_dist_argument, finish,
                                         is_primary, start)
from sr3_tpu_torch.training.evaluation import infer_sr
from sr3_tpu_torch.training.trainer import create_model


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str,
                        default="configs/sr_sr3_16_128.json")
    parser.add_argument("-p", "--phase", type=str, choices=["val"],
                        default="val")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)
    parser.add_argument("-debug", "-d", action="store_true")
    add_dist_argument(parser)
    parser.add_argument("-enable_wandb", action="store_true")
    parser.add_argument("-log_infer", action="store_true")
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

    wandb_logger = None
    if opt["enable_wandb"] and primary:
        from sr3_tpu_torch.utils.wandb_logger import WandbLogger

        wandb_logger = WandbLogger(opt)

    val_set = create_dataset(opt["datasets"]["val"], "val")
    logger.info("Initial Dataset Finished")

    trainer = create_model(opt, mesh=mesh)
    trainer.print_network()
    logger.info("Initial Model Finished")
    trainer.set_new_noise_schedule(opt["model"]["beta_schedule"]["val"],
                                   schedule_phase="val")

    logger.info("Begin Model Inference.")
    infer_sr(trainer, val_set, opt, wandb_logger=wandb_logger)
    logger.info("End of Model Inference.")


if __name__ == "__main__":
    main()
