"""Options and logging of the port.

Configs are the JAX package's JSON files, read by its numpy-only host code
(``sr3_tpu.utils.config``, imported rather than copied). Its
``setup_logger`` imports jax, so the port keeps its own.
"""

from __future__ import annotations

import logging
import os

from sr3_tpu.utils.config import (dict2str, dict_to_nonedict,  # noqa: F401
                                  load_json_with_comments, parse)


def load_config(path):
    """A JSON config (``//`` comments allowed) as nested NoneDicts, without
    ``parse``'s experiment directories: for scripts that build a model
    straight from a config file."""
    return dict_to_nonedict(load_json_with_comments(path))


def setup_logger(logger_name, root, phase, level=logging.INFO, screen=False):
    """File logger ``{root}/{phase}.log`` (+ console), as the JAX package's
    config.setup_logger sets it up for one process."""
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
