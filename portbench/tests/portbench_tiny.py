"""A tiny cell for the CPU tests: the 16->128 configuration cut to a 16^2
image, inner width 16, two levels and one res block, in a directory laid
out as ``portbench/`` is, judged by the real cells' limits."""

import copy
import json
import os
import shutil

from portbench import cells

SAMPLE, TRAIN = "tiny.sample", "tiny.train"
LIMITS_OF = {SAMPLE: "sr3_16_128.ancestral_b128",
             TRAIN: "sr3_16_128.train_b128"}


def tiny_opt():
    opt = copy.deepcopy(cells.config("sr3_16_128")["opt"])
    opt["model"]["unet"].update(inner_channel=16, norm_groups=8,
                                channel_multiplier=[1, 2], attn_res=[8],
                                res_blocks=1)
    opt["model"]["diffusion"]["image_size"] = 16
    for part in ("train", "val"):
        opt["datasets"][part].update(l_resolution=4, r_resolution=16)
    return opt


def write(base):
    """Lay the tiny cell out under ``base``; returns its BENCHMARK dict."""
    for sub in ("configs", "traffic", "limits", "metrics"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    with open(os.path.join(base, "configs", "tiny.json"), "w") as f:
        json.dump({"name": "tiny", "opt": tiny_opt()}, f)
    sample = dict(cells.traffic("ancestral_b8"), batch=4)
    train = dict(cells.traffic("train_b128"), batch=4, resident=8)
    for name, t in (("sample", sample), ("train", train)):
        with open(os.path.join(base, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    for cell, real in LIMITS_OF.items():
        shutil.copy(os.path.join(cells.HERE, "limits", real + ".json"),
                    os.path.join(base, "limits", cell + ".json"))
    bench = copy.deepcopy(cells.benchmark())
    bench["workloads"] = [
        {"name": c, "config": "tiny", "traffic": c.split(".")[1], "chips": 1}
        for c in (SAMPLE, TRAIN)]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [SAMPLE if "sample" in w or "ancestral" in w
                              else TRAIN for w in m["workloads"]]
    return bench
