"""One rank of the port's parallel tests (gloo on the CPU; no JAX).

  python -m tests.torch_port_parallel_worker SPEC OUT_DIR

Started by ``tests/torch_port_parallel_common.py`` through
``torch.distributed.run``. ``SPEC`` is a
``torch.save``d dict: the config's ``parallel`` block, the case names and
their inputs (made in the pytest process from numpy seeds). The rank runs
every case and saves {case: result} to ``OUT_DIR/rank{RANK}.pt``.
"""

import copy
import functools
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from sr3_tpu_torch.models.unet import UNet
from sr3_tpu_torch.ops import dropout as port_dropout
from sr3_tpu_torch.ops.conv_fused import gn_silu_conv3x3_space
from sr3_tpu_torch.parallel import sharding_rules as tp
from sr3_tpu_torch.parallel import spatial
from sr3_tpu_torch.parallel.mesh import data_slice, init_mesh, shard_batch
from sr3_tpu_torch.training.evaluation import GroupedEvaluator
from sr3_tpu_torch.training.trainer import create_model


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) \
        .contiguous(memory_format=torch.channels_last)


def whole_grads(net):
    """{name: whole gradient} (gathered over the model axis)."""
    names = [n for n, _ in net.named_parameters()]
    grads = [p.grad for _, p in net.named_parameters()]
    axis = tp.model_axis(net)
    if axis is not None:
        grads = list(tp.full_tensors(grads, names, tp.sharded_names(net),
                                     axis).values())
    return {n: g.numpy().copy() for n, g in zip(names, grads)}


def whole_params(net, tensors=None):
    names = [n for n, _ in net.named_parameters()]
    vals = [p.detach() for _, p in net.named_parameters()] \
        if tensors is None else list(tensors)
    axis = tp.model_axis(net)
    if axis is not None:
        vals = list(tp.full_tensors(vals, names, tp.sharded_names(net),
                                    axis).values())
    return {n: v.numpy().copy() for n, v in zip(names, vals)}


def masks_in_order(masks, rows):
    """A ``dropout_mask`` stand-in handing out the recorded masks (NHWC,
    whole batch) in call order, cut to this rank's batch ``rows``."""
    it = iter(masks)

    def mask(x, keep, generator=None):
        m = torch.from_numpy(next(it)[rows]).permute(0, 3, 1, 2)
        assert tuple(m.shape) == tuple(x.shape), (m.shape, x.shape)
        return m
    return mask


# ------------------------------------------------------------------ cases


def case_mesh(mesh, spec):
    return {"coords": mesh.coords, "primary": mesh.is_primary,
            "shape": mesh.shape}


def case_train_step(mesh, spec):
    """One optimize_parameters step on the rank's slice of the global batch
    with injected noise, sqrt-gamma and dropout masks (when given)."""
    trainer = create_model(copy.deepcopy(spec["train_opt"]), mesh=mesh)
    trainer.set_new_noise_schedule(spec["sched"])
    rows = data_slice(len(spec["batch"]["HR"]), mesh)
    trainer.feed_data(shard_batch(spec["batch"], mesh))
    if "noise" in spec:
        trainer.diffusion.p_losses = functools.partial(
            trainer.diffusion.p_losses,
            injected={"noise": nchw(spec["noise"][rows]).contiguous(),
                      "sqrt_gamma": torch.from_numpy(spec["gamma"][rows])})
    if "masks" in spec:
        port_dropout.dropout_mask = masks_in_order(spec["masks"], rows)
    trainer.optimize_parameters()
    out = {"loss": trainer.get_current_log()["l_pix"],
           "grads": whole_grads(trainer.netG),
           "params": whole_params(trainer.netG),
           "reduced_bytes": trainer.reduced_bytes,
           "sharded": sorted(tp.sharded_names(trainer.netG)),
           "local_shapes": {n: tuple(p.shape) for n, p
                            in trainer.netG.named_parameters()}}
    if trainer.use_ema:
        out["ema"] = whole_params(trainer.netG, trainer.ema.values())
    if spec.get("checkpoint"):
        trainer.save_network(1, 1)
    return out


def case_run_sr(mesh, spec):
    """Grouped SR over the data axis, the val schedule, fixed base seed."""
    trainer = create_model(copy.deepcopy(spec["val_opt"]), mesh=mesh)
    trainer.set_new_noise_schedule(spec["sched"], "val")
    ev = GroupedEvaluator(trainer, spec["group"], base_seed=123)
    items = [{"SR": x} for x in spec["items"]]
    return {"frames": np.stack([f for _, f in ev.run_sr(items, True)])}


def case_halo(mesh, spec):
    """halo_exchange of this rank's rows of x and its backward for the
    rank's own output gradients (seeded by rank)."""
    axis = mesh.space
    x = torch.from_numpy(spec["x"]).requires_grad_()
    xs = spatial.slice_rows(x, axis)
    top, bottom = spatial.halo_exchange(xs, axis)
    rng = np.random.default_rng(100 + axis.rank)
    gt = torch.from_numpy(rng.standard_normal(top.shape).astype(np.float32))
    gb = torch.from_numpy(rng.standard_normal(top.shape).astype(np.float32))
    (top * gt).sum().add((bottom * gb).sum()).backward()
    return {"top": top.detach().numpy(), "bottom": bottom.detach().numpy(),
            "dx": x.grad.numpy()}


def case_halo_k1(mesh, spec):
    """The plain halo K1 (gn_silu_conv3x3_space on the CPU) on this rank's
    rows: output rows and the gradients of a seeded weighting."""
    axis = mesh.space
    k = {n: torch.from_numpy(v).requires_grad_() for n, v in
         spec["k1"].items()}
    x = k["x"].contiguous(memory_format=torch.channels_last)
    res = k["res"].contiguous(memory_format=torch.channels_last)
    y = gn_silu_conv3x3_space(
        spatial.slice_rows(x, axis), k["gw"], k["gb"],
        k["w"].contiguous(memory_format=torch.channels_last), k["b"],
        spec["groups"], axis, pre_bias=k["pb"],
        residual=spatial.slice_rows(res, axis))
    g = torch.from_numpy(spec["k1_g"])
    (y * spatial.slice_rows(g, axis)).sum().backward()
    return {"y": y.detach().numpy(),
            "grads": {n: t.grad.numpy() for n, t in k.items()}}


def _unet(spec, mesh):
    net = UNet(**spec["unet"])
    net.load_state_dict(spec["state"])
    net = net.to(memory_format=torch.channels_last)
    net.set_parallel(mesh)
    return net


def case_forward(mesh, spec):
    net = _unet(spec, mesh).eval()
    with torch.no_grad():
        out = net(nchw(spec["fwd_x"]), torch.from_numpy(spec["fwd_t"]))
    return {"out": out.numpy()}


def case_chain(mesh, spec):
    """The T-step ancestral chain (continuous frames) with an injected
    noise stream."""
    from sr3_tpu_torch.models.diffusion import GaussianDiffusion
    from sr3_tpu_torch.models.schedule import make_schedule

    net = _unet(spec, mesh).eval()
    diff = GaussianDiffusion(net, spec["unet"]["image_size"])
    sched = make_schedule(spec["sched"], "cpu")
    init, steps = spec["stream"]
    with torch.no_grad():
        out = diff.p_sample_loop(
            net, sched, nchw(spec["cond"]), continuous=True,
            noise_stream=(nchw(init),
                          torch.from_numpy(steps).permute(0, 1, 4, 2, 3)))
    return {"frames": out.numpy()}


def case_loss_grads(mesh, spec):
    """One train step (loss, backward, gradient reduction, Adam) with the
    trainer's own generator: noise and dropout drawn at full size."""
    trainer = create_model(copy.deepcopy(spec["train_opt"]), mesh=mesh)
    trainer.set_new_noise_schedule(spec["sched"])
    trainer.feed_data(spec["batch"])
    trainer.optimize_parameters()
    out = {"loss": trainer.get_current_log()["l_pix"],
           "grads": whole_grads(trainer.netG),
           "params": whole_params(trainer.netG),
           "sharded": sorted(tp.sharded_names(trainer.netG)),
           "local_numel": sum(p.numel() for p in trainer.netG.parameters())}
    if trainer.use_ema:
        out["ema"] = whole_params(trainer.netG, trainer.ema.values())
    if spec.get("checkpoint"):
        trainer.save_network(1, 1)
    return out


def case_gather_sum(mesh, spec):
    """d/dx of sum(w * gather_channels(x_slice)) must be w's slice (a
    gather whose backward summed would give m times it)."""
    axis = mesh.model
    w = torch.from_numpy(spec["gw"])
    n = w.shape[1] // axis.size
    xs = w[:, axis.rank * n:(axis.rank + 1) * n].clone().requires_grad_()
    (tp.gather_channels(xs, axis) * w).sum().backward()
    gp = torch.from_numpy(spec["gp"])
    n = gp.shape[0] // axis.size
    p = gp[axis.rank * n:(axis.rank + 1) * n].clone().requires_grad_()
    (tp.gather_param(p, SimpleNamespace(tp=axis)) * gp).sum().backward()
    return {"dx": xs.grad.numpy(), "dp": p.grad.numpy()}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = init_mesh(spec["parallel"], backend="gloo", device="cpu")
    out = {case: CASES[case](mesh, spec) for case in spec["cases"]}
    torch.save(out, os.path.join(out_dir, f"rank{os.environ['RANK']}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
