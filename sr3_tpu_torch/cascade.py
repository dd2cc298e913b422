"""Cascaded multi-stage generation driver of the port, CLI-compatible with
the root cascade.py:

  # unconditional 128^2 seeds -> 128->1024 SR
  python -m sr3_tpu_torch.cascade -c configs/sample_sr3_128.json \
      -c configs/sr_sr3_128_1024.json -n 4 -o results/cascade

  # start from a directory of low-resolution images instead
  python -m sr3_tpu_torch.cascade -i my_16px_faces/ \
      -c configs/sr_sr3_16_128.json -c configs/sr_sr3_128_1024.json

Per stage, set ``path.resume_state`` in the config (or pass one -r per -c,
in order) to its trained checkpoint. Between stages the outputs are
bicubic-resized to the next stage's image_size with the prep tool's resize
(``training/cascade.py``). The device is CUDA; ``SR3_PLATFORM=cpu`` runs it
on the CPU.

Several ranks: ``torchrun --nproc_per_node N -m sr3_tpu_torch.cascade ...``
with a config ``"parallel": {"data": D, "model": M, "space": S}`` block,
D * M * S = N (``sr3_tpu_torch/parallel/mesh.py``; ``--dist-backend``,
default nccl on CUDA, gloo on the CPU); only the primary rank writes.
"""

from __future__ import annotations

import argparse
import logging
from types import SimpleNamespace

import sr3_tpu_torch.utils.config as Config
from sr3_tpu_torch.parallel.mesh import (add_dist_argument, finish,
                                         is_primary, start)
from sr3_tpu_torch.training.cascade import load_input_images, run_cascade


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", action="append", required=True,
                        help="stage config; repeat in cascade order")
    parser.add_argument("-r", "--resume", action="append", default=None,
                        help="per-stage resume_state override (repeat, in "
                             "-c order; '-' keeps the config's value)")
    parser.add_argument("-n", "--n_samples", type=int, default=4,
                        help="sample count when stage 1 is unconditional")
    parser.add_argument("-i", "--input", type=str, default=None,
                        help="directory of images seeding a conditional "
                             "stage 1")
    parser.add_argument("-o", "--out", type=str, default=None,
                        help="output dir (default: first stage's results)")
    parser.add_argument("-gpu", "--gpu_ids", type=str, default=None)
    parser.add_argument("-debug", "-d", action="store_true")
    add_dist_argument(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    blocks = [Config.load_json_with_comments(c).get("parallel")
              for c in args.config]
    if any(b != blocks[0] for b in blocks):
        raise ValueError(f"the stages' parallel blocks differ: {blocks}; "
                         f"the ranks run every stage on one mesh")
    mesh = start(args, blocks[0])
    opts = []
    for k, cfg in enumerate(args.config):
        stage_args = SimpleNamespace(config=cfg, phase="val",
                                     gpu_ids=args.gpu_ids, debug=args.debug,
                                     timestamp=getattr(args, "timestamp",
                                                       None))
        opt = Config.dict_to_nonedict(Config.parse(stage_args))
        if args.resume and k < len(args.resume) and args.resume[k] != "-":
            opt["path"]["resume_state"] = args.resume[k]
        opts.append(opt)

    if is_primary(mesh):
        Config.setup_logger(None, opts[0]["path"]["log"], "train",
                            screen=True)
    logger = logging.getLogger("base")

    input_images = load_input_images(args.input) if args.input else None
    out_dir = args.out or opts[0]["path"]["results"]
    images = run_cascade(opts, n_samples=args.n_samples,
                         input_images=input_images, out_dir=out_dir,
                         mesh=mesh)
    logger.info("Cascade done: %d images at %s in %s", len(images),
                f"{images[0].shape[0]}^2" if images else "-", out_dir)
    finish(mesh)


if __name__ == "__main__":
    main()
