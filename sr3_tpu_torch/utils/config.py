"""Options and logging of the port.

The port's own copy of the JAX package's config surface
(``sr3_tpu/utils/config.py``): JSON with line-wise ``//`` comments, the
timestamped experiment directory tree, the ``-debug`` shrink, NoneDict
missing-key semantics and the ``dict2str`` pretty printer. ``gpu_ids`` only
records the requested device count. The logger is the port's own: one
process writes ``{phase}.log``.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from datetime import datetime


class NoneDict(dict):
    """dict that returns None for missing keys."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """Recursively convert dicts to NoneDict."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def dict2str(opt, indent_l=1):
    """Pretty-print a nested dict for logging."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def get_timestamp():
    return datetime.now().strftime("%y%m%d_%H%M%S")


def mkdirs(paths):
    if isinstance(paths, str):
        os.makedirs(paths, exist_ok=True)
    else:
        for p in paths:
            os.makedirs(p, exist_ok=True)


def load_json_with_comments(path):
    """Read JSON where everything after ``//`` on a line is a comment."""
    json_str = ""
    with open(path, "r") as f:
        for line in f:
            json_str += line.split("//")[0] + "\n"
    return json.loads(json_str, object_pairs_hook=OrderedDict)


def parse(args):
    """The CLI's options: the config file, its experiment directories under
    ``experiments/{name}_{timestamp}``, the phase, the ``-debug`` shrink and
    the logging flags.

    ``args`` needs: config, phase, gpu_ids, debug, enable_wandb and
    optionally log_wandb_ckpt / log_eval / log_infer and timestamp (the
    experiment directory's, default now).
    """
    phase = args.phase
    opt = load_json_with_comments(args.config)

    if getattr(args, "debug", False):
        opt["name"] = "debug_{}".format(opt["name"])
    # ranks of one run share the timestamp they agreed on (mesh.start)
    stamp = getattr(args, "timestamp", None) or get_timestamp()
    experiments_root = os.path.join(
        "experiments", "{}_{}".format(opt["name"], stamp))
    opt["path"]["experiments_root"] = experiments_root
    for key, path in opt["path"].items():
        if "resume" not in key and "experiments" not in key:
            opt["path"][key] = os.path.join(experiments_root, path)
            mkdirs(opt["path"][key])

    opt["phase"] = phase

    gpu_ids = getattr(args, "gpu_ids", None)
    if gpu_ids is not None:
        opt["gpu_ids"] = [int(x) for x in gpu_ids.split(",")]
    opt["distributed"] = bool(opt.get("gpu_ids")) and len(opt["gpu_ids"]) > 1

    if "debug" in opt["name"]:
        opt["train"]["val_freq"] = 2
        opt["train"]["print_freq"] = 2
        opt["train"]["save_checkpoint_freq"] = 3
        opt["datasets"]["train"]["batch_size"] = 2
        opt["model"]["beta_schedule"]["train"]["n_timestep"] = 10
        opt["model"]["beta_schedule"]["val"]["n_timestep"] = 10
        opt["datasets"]["train"]["data_len"] = 6
        opt["datasets"]["val"]["data_len"] = 3

    # validation during training runs on 3 images
    if phase == "train":
        opt["datasets"]["val"]["data_len"] = 3

    for flag in ("log_wandb_ckpt", "log_eval", "log_infer"):
        if hasattr(args, flag):
            opt[flag] = getattr(args, flag)
    opt["enable_wandb"] = getattr(args, "enable_wandb", False)

    return opt


def load_config(path):
    """A JSON config (``//`` comments allowed) as nested NoneDicts, without
    ``parse``'s experiment directories: for scripts that build a model
    straight from a config file."""
    return dict_to_nonedict(load_json_with_comments(path))


def setup_logger(logger_name, root, phase, level=logging.INFO, screen=False):
    """File logger ``{root}/{phase}.log`` (+ console) for one process."""
    logger = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    fh = logging.FileHandler(os.path.join(root, f"{phase}.log"), mode="w")
    fh.setFormatter(formatter)
    logger.setLevel(level)
    logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
