"""The ADM 128->512 cell's configuration cut to CPU size for the tests:
model_channels 32, channel_mult (1, 2), one ResBlock a level, heads of 16
channels at ds 2 (an 8^2 map), 4 classes, 16^2 from 4^2, float32, the
schedule respaced to 10 of its 1000 steps."""

import copy

from portbench import cells

CELL = "adm_128_512.ancestral250_b8"
TRAFFIC = {"kind": "adm_sample", "sampler": "ancestral", "T": 10,
           "T_train": 1000, "batch": 4}


def tiny_opt(respacing="10"):
    opt = copy.deepcopy(cells.config("adm_128_512")["opt"])
    opt["model"]["unet"].update(inner_channel=32, channel_multiplier=[1, 2],
                                attn_res=[8], res_blocks=1,
                                num_head_channels=16, num_classes=4)
    opt["model"].pop("dtype")  # float32 on the CPU
    opt["model"]["diffusion"]["image_size"] = 16
    opt["datasets"]["val"].update(l_resolution=4, r_resolution=16)
    opt["model"]["beta_schedule"]["val"]["timestep_respacing"] = respacing
    return opt
