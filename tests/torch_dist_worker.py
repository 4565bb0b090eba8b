"""One rank of the port's data-parallel tests: gloo ranks on the CPU.

    python tests/torch_dist_worker.py SCENARIO IN.pt OUT.pt --rank R --world W --port P \
        [--slices S] [--devices]

Imports torch and the port only (no JAX, so a rank starts in about a
second). Reads the scenario's inputs from IN.pt (written by the test, the
global batch and the starting weights), starts rank R of W
(``multihost.initialize``, gloo, the coordinator at localhost:P, S slices),
runs the
scenario on the rank's rows and writes what it computed to OUT.pt. The
scenario functions also run in the test's own process with ``mesh`` None:
the single-process reference on the global batch.

Scenarios:

- ``ops``: train-mode BatchNorm forward and backward, the fused loss (plain
  B1/B2), the unfused loss with bootstrapping, and ``bootstrap_weights``;
- ``step``: train steps of the tiny model (tests/helpers.py TINY_BLOCKS),
  one run per settings variant (fused optimizer, optax path, accumulation,
  augmentations, two slices);
- ``preempt``: the training loop, with SIGTERM sent to rank 1 alone;
- ``eval``: ``SemanticSegmentation.evaluate`` of the small model, run with
  ``--devices`` (the ranks of one process's devices, which take rows of
  each eval batch);
- ``spatial_ops`` (with ``--spatial P``): each op with a spatial extent on
  the rank's band of rows of a global input, forward and backward;
- ``summary``: the training loop's image-summary forward, run by rank 0
  alone while the other ranks wait at a host barrier;
- ``fused_bn``: ``ops/fused_bn.batch_norm_train`` forward and backward on
  the rank's rows (or, with ``--spatial P``, its band of rows of each
  image) over the active mesh.

With ``--spatial P`` the ranks split image height in groups of P.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from iv2019_tpu_torch.config import Settings  # noqa: E402
from iv2019_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from iv2019_tpu_torch.parallel import multihost  # noqa: E402

LOGIT_KEYS = ("l1_logits", "l2_vehicle_logits", "l2_human_logits")
LOSS_KEYS = ("total", "l1_segmentation", "l2_vehicle_segmentation", "l2_human_segmentation")


def rows(x, mesh):
    """The rank's rows of a global array (all of them without a mesh)."""
    if mesh is None:
        return x
    return pmesh.shard_rows(x, mesh.rank, mesh.world)


def typed_rows(x, sizes, mesh):
    """The rank's rows of each sub-batch of a [pp | pb | pi] array."""
    if mesh is None:
        return x
    edges = np.cumsum((0,) + tuple(sizes))
    parts = [rows(x[a:b], mesh) for a, b in zip(edges[:-1], edges[1:])]
    return np.concatenate(parts)


# -------------------------------------------------------------------- ops


def batch_norm(inp, mesh):
    from iv2019_tpu_torch.models.layers import Norm

    norm = Norm(inp["x"].shape[1], decay=inp["decay"]).train()
    with torch.no_grad():
        for k in ("scale", "bias", "mean", "var"):
            getattr(norm, k).copy_(torch.from_numpy(inp[k]))
    x = torch.from_numpy(rows(inp["x"], mesh)).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = norm(x)
    y.backward(torch.from_numpy(rows(inp["dy"], mesh)))
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": norm.scale.grad.numpy(),
            "dbias": norm.bias.grad.numpy(), "mean": norm.mean.numpy(),
            "var": norm.var.numpy()}


def fused_loss(inp, mesh):
    from iv2019_tpu_torch.ops.fused_loss import define_losses_fused
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    labels = inp["labels"]
    sizes = [len(labels[k]) for k in ("prolabels_per_pixel", "prolabels_per_bbox",
                                      "prolabels_per_image")]
    preds = {k: torch.from_numpy(typed_rows(inp["lr"][k], sizes, mesh)).requires_grad_(True)
             for k in LOGIT_KEYS}
    got = define_losses_fused(preds, {k: torch.from_numpy(rows(v, mesh))
                                      for k, v in labels.items()},
                              get_taxonomy(inp["dataset"]), inp["out_hw"], mesh=mesh)
    got["total"].backward()
    out = {k: float(got[k].detach()) for k in LOSS_KEYS}
    out.update({f"grad_{k}": preds[k].grad.numpy() for k in LOGIT_KEYS})
    out.update(decisions=got["decisions"].numpy(), l1_decisions=got["l1_decisions"].numpy())
    return out


def losses(inp, mesh):
    from iv2019_tpu_torch.losses.hierarchical import define_losses
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    labels = inp["labels"]
    sizes = [len(labels[k]) for k in ("prolabels_per_pixel", "prolabels_per_bbox",
                                      "prolabels_per_image")]
    logits = {k: torch.from_numpy(typed_rows(inp["logits"][k], sizes, mesh)).requires_grad_(True)
              for k in LOGIT_KEYS}
    preds = dict(logits, l1_decisions=logits["l1_logits"].detach().argmax(-1).int())
    got = define_losses(preds, {k: torch.from_numpy(rows(v, mesh)) for k, v in labels.items()},
                        get_taxonomy(inp["dataset"]),
                        bootstrapping_percentage=inp["boot"], mesh=mesh)
    got["total"].backward()
    out = {k: float(got[k].detach()) for k in LOSS_KEYS}
    out.update({f"grad_{k}": logits[k].grad.numpy() for k in LOGIT_KEYS})
    out.update({k: got[k].numpy() for k in ("l1_weights", "l2_vehicle_weights",
                                            "l2_human_weights")})
    return out


def bootstrap(inp, mesh):
    from iv2019_tpu_torch.losses.hierarchical import bootstrap_weights

    return [bootstrap_weights(torch.from_numpy(rows(raw, mesh)),
                              torch.from_numpy(rows(w, mesh)), p, mesh).numpy()
            for raw, w, p in inp]


def run_ops(inp, mesh):
    return {"bn": batch_norm(inp["bn"], mesh),
            "fused_loss": [fused_loss(c, mesh) for c in inp["fused_loss"]],
            "losses": [losses(c, mesh) for c in inp["losses"]],
            "bootstrap": bootstrap(inp["bootstrap"], mesh)}


# ------------------------------------------------------------------- step


def tiny_model(settings, state_dict, blocks):
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy

    model = HierarchicalSegmentationModel(
        taxonomy=get_taxonomy(settings.per_pixel_dataset_name), resnet_blocks=blocks,
        feature_dims_decreased=settings.feature_dims_decreased, dtype=torch.float32,
        upsampling_method=settings.upsampling_method, batch_norm_decay=settings.batch_norm_decay,
    ).to(memory_format=torch.channels_last).train()
    model.load_state_dict(state_dict)
    return model


def run_step(settings, state_dict, blocks, batch, steps, mesh):
    """``steps`` train steps on the rank's rows of ``batch``: the metrics and
    collectives of each, the gradient of step 1, and the state after."""
    from iv2019_tpu_torch.train.fused_update import FusedSGDM
    from iv2019_tpu_torch.train.optimizer import make_optimizer
    from iv2019_tpu_torch.train.state import (create_fused_train_state, create_train_state,
                                              momentum_buffers)
    from iv2019_tpu_torch.train.step import make_train_step

    model = tiny_model(settings, state_dict, blocks)
    if settings.fused_optimizer:
        opt = FusedSGDM(settings, model)
        state = create_fused_train_state(opt)
        step_fn = make_train_step(settings, fused_opt=opt, mesh=mesh)
    else:
        tx, _ = make_optimizer(settings, model)
        state = create_train_state(model, tx, settings.ema_decay)
        step_fn = make_train_step(settings, model=model, mesh=mesh)
    if mesh is None:
        local = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        local = multihost.put_sharded(batch, mesh, settings.grad_accum_steps)
    metrics, collectives, grads = [], [], None
    for i in range(steps):
        pmesh.reset_collective_stats()
        state, m = step_fn(state, local)
        collectives.append(pmesh.collective_stats())
        metrics.append({k: float(v) for k, v in m.items() if k != "weight_masks"})
        if i == 0:
            params = list(model.parameters())
            grads = (opt.grads.clone() if settings.fused_optimizer else
                     torch.cat([p.grad.reshape(-1) for p in params]))
            model1 = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    out = {"metrics": metrics, "collectives": collectives, "grads": grads.numpy(),
           "model1": model1,
           "model": {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}}
    if settings.fused_optimizer:
        out["momentum"] = state.opt_state.momentum.numpy()
        out["ema"] = state.opt_state.ema_biased.numpy()
    else:
        out["momentum"] = {k: v.numpy() for k, v in momentum_buffers(state).items()}
        out["ema"] = {k: v.numpy() for k, v in state.ema.biased.items()}
    return out


def run_steps(inp, mesh):
    return {name: run_step(s, inp["state_dict"], inp["blocks"], inp["batch"], inp["steps"],
                           mesh)
            for name, s in inp["variants"].items()}


def run_preempt(inp, mesh):
    """The training loop of the tiny model on the rank's rows of a constant
    batch; rank 1 (alone) gets SIGTERM as its input pipeline makes batch
    ``inp["signal_at"]``. Returns the step each rank stopped at, the
    checkpoints on disk, and a digest of the parameters."""
    import signal

    from iv2019_tpu_torch.train.loop import train

    settings = inp["settings"]
    model = tiny_model(settings, inp["state_dict"], inp["blocks"])
    rows_of = {k: rows(v, mesh) for k, v in inp["batch"].items()}

    def batches():
        for i in range(inp["max_steps"] + 2):
            if mesh.rank == 1 and i == inp["signal_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            yield rows_of

    state = train(settings, batches(), model=model, max_steps=inp["max_steps"], log_every=1,
                  image_summaries=False)
    ckpt_dir = os.path.join(settings.log_dir, "checkpoints")
    return {"step": int(state.step), "checkpoints": sorted(os.listdir(ckpt_dir)),
            "params": torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()}


# ------------------------------------------------------------------- eval


def run_eval(inp, mesh):
    """``SemanticSegmentation.evaluate`` of the small model from a converted
    checkpoint over synthetic eval batches: the global step and confusion
    matrix of each checkpoint. On the ranks of one process's devices each
    rank takes its rows of each (grouped) batch."""
    from iv2019_tpu_torch.input import cityscapes
    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.system import SemanticSegmentation

    def model_fn(settings):
        return HierarchicalSegmentationModel(
            taxonomy=get_taxonomy(settings.per_pixel_dataset_name), resnet_blocks=inp["blocks"],
            feature_dims_decreased=settings.feature_dims_decreased, dtype=torch.float32,
        ).to(memory_format=torch.channels_last).eval()

    system = SemanticSegmentation({"eval": cityscapes.evaluate_input}, model_fn=model_fn,
                                  settings=Settings(**inp["settings"]))
    return [(m["global_step"], m["confusion_matrix"]) for m in system.evaluate()]


# ------------------------------------------------------------- spatial ops


def _spatial_op(case):
    """(function of the input, named parameters) of a spatial-op case, its
    parameters drawn from the case's seed (alike on every rank)."""
    from iv2019_tpu_torch.models.layers import BottleneckV1, ConvNormRelu, Norm, conv_same
    from iv2019_tpu_torch.models.model import ConvTranspose, PSPModule, init_model
    from iv2019_tpu_torch.models.resnet import _RootConv, max_pool_same
    from iv2019_tpu_torch.ops.resize import resize_band, resize_bilinear_mxu, resize_nearest

    gen = torch.Generator().manual_seed(case["seed"])
    op, kw = case["op"], case.get("kw", {})

    def module(m):
        init_model(m, gen)
        for norm in m.modules():
            if isinstance(norm, Norm) and norm.norm_type != "none":
                with torch.no_grad():
                    norm.scale.uniform_(0.5, 1.5, generator=gen)
                    norm.bias.uniform_(-0.5, 0.5, generator=gen)
        return m.to(memory_format=torch.channels_last)

    if op == "conv":
        w = torch.nn.Parameter(torch.randn(kw["cout"], kw["cin"], kw["k"], kw["k"],
                                           generator=gen) * 0.2)
        return (lambda x: conv_same(x, w, kw["stride"], kw["rate"])), {"w": w}
    if op == "root":
        m = module(_RootConv(getattr(torch, kw["dtype"]), wgrad_kernel=True))
        return m, dict(m.named_parameters())
    if op == "maxpool":
        return max_pool_same, {}
    if op in ("bilinear", "nearest"):
        size = kw["size"]

        def resize(x):
            mesh = pmesh.spatial_mesh()
            if mesh is not None:
                return resize_band(x, size, mesh, nearest=op == "nearest")
            if op == "nearest":
                return resize_nearest(x, size, align_corners=True)
            return resize_bilinear_mxu(x, size, align_corners=True)
        return resize, {}
    if op == "psp":
        m = module(PSPModule(kw["cin"], kw["features"], torch.float32, kw["norm"])).train()
        return m, dict(m.named_parameters())
    if op == "group_norm":
        m = module(Norm(kw["c"], norm_type="group", groups=kw["groups"]))
        return m, dict(m.named_parameters())
    if op == "fov":
        m = module(ConvNormRelu(kw["c"], kw["c"], 3, rate=kw["rate"], dtype=torch.float32)).train()
        return m, dict(m.named_parameters())
    if op == "hybrid":
        m = module(ConvTranspose(kw["c"], torch.float32))
        return m, dict(m.named_parameters())
    if op == "fused":
        m = module(BottleneckV1(kw["c"], kw["c"], kw["m"], rate=kw["rate"], fused_block=True,
                                dtype=torch.bfloat16)).eval()
        return m, {}
    raise ValueError(op)


def _band(x, dim, mesh):
    """The rank's band of rows of ``x`` along ``dim`` (any height)."""
    if mesh is None or mesh.spatial == 1:
        return x
    n = x.shape[dim] // mesh.spatial
    return x.narrow(dim, mesh.spatial_index * n, n)


def run_spatial_ops(inp, mesh):
    """Per case: the output of the rank's band (y), the gradient of its
    input band (dx) and of the parameters (this rank's part)."""
    out = []
    for case in inp:
        fn, params = _spatial_op(case)
        x = _band(torch.from_numpy(case["x"]), case["dim"], mesh)
        if case["x"].ndim == 4 and case["dim"] == 2:
            x = x.contiguous(memory_format=torch.channels_last)
        grad = x.is_floating_point() and case.get("dy") is not None
        if grad:
            x = x.clone().requires_grad_(True)
        y = fn(x)
        res = {"y": y.detach().float().numpy()}
        if grad:
            dy = _band(torch.from_numpy(case["dy"]), case["dim"], mesh)
            y.backward(dy.to(y.dtype))
            res["dx"] = x.grad.float().numpy()
            res["grads"] = {k: p.grad.numpy() for k, p in params.items() if p.grad is not None}
        out.append(res)
    return out


def run_summary(inp, mesh):
    """Rank 0 runs the image-summary forward by itself; every rank then
    meets at the host barrier. Returns rank 0's decisions."""
    from iv2019_tpu_torch.train.loop import _image_summaries

    model = tiny_model(inp["settings"], inp["state_dict"], inp["blocks"])
    palette = np.arange(256 * 3, dtype=np.uint8).reshape(256, 3)
    out = {}
    if mesh is None or mesh.rank == 0:
        images = _image_summaries(model, {k: torch.from_numpy(v) for k, v in inp["batch"].items()},
                                  palette, None)
        out["decisions"] = images["decisions"]
    if mesh is not None:
        pmesh.barrier(mesh)
    return out


def run_fused_bn(inp, mesh):
    """``batch_norm_train`` of the rank's part of NCHW ``x`` (its rows, or
    its band of rows of each image under a spatial mesh) and its backward
    of ``dy``'s part: y, dx, this rank's dscale and dbias, the global
    statistics and the collectives it made."""
    from iv2019_tpu_torch.ops.fused_bn import batch_norm_train

    def part(a):
        if mesh is not None and mesh.spatial > 1:
            t = _band(torch.from_numpy(a), 2, mesh)
        else:
            t = torch.from_numpy(rows(a, mesh))
        return t.contiguous(memory_format=torch.channels_last)

    x = part(inp["x"]).requires_grad_(True)
    scale = torch.from_numpy(inp["scale"]).requires_grad_(True)
    bias = torch.from_numpy(inp["bias"]).requires_grad_(True)
    pmesh.reset_collective_stats()
    y, mean, var = batch_norm_train(x, scale, bias, inp["eps"], pmesh.norm_mesh())
    y.backward(part(inp["dy"]))
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dscale": scale.grad.numpy(),
            "dbias": bias.grad.numpy(), "mean": mean.numpy(), "var": var.numpy(),
            "all_reduces": pmesh.collective_stats()["all_reduce"]}


SCENARIOS = {"ops": run_ops, "step": run_steps, "preempt": run_preempt, "eval": run_eval,
             "spatial_ops": run_spatial_ops, "summary": run_summary, "fused_bn": run_fused_bn}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("scenario", choices=sorted(SCENARIOS))
    p.add_argument("inp")
    p.add_argument("out")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--slices", type=int, default=1)
    p.add_argument("--spatial", type=int, default=1)
    p.add_argument("--devices", action="store_true",
                   help="the ranks of one process's devices (num_devices W), not W processes")
    args = p.parse_args()
    torch.set_num_threads(1)
    coordinator = f"localhost:{args.port}"
    if args.devices:
        settings = Settings(device="cpu", num_devices=args.world, coordinator_address=coordinator,
                            num_slices=args.slices, spatial_partitions=args.spatial)
        mesh = multihost.initialize(settings, backend="gloo", local_rank=args.rank)
    else:
        settings = Settings(device="cpu", num_processes=args.world, process_id=args.rank,
                            coordinator_address=coordinator, num_slices=args.slices,
                            spatial_partitions=args.spatial)
        mesh = multihost.initialize(settings, backend="gloo")
    try:
        inp = torch.load(args.inp, weights_only=False)
        torch.save(SCENARIOS[args.scenario](inp, mesh), args.out)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
