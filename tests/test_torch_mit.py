"""The port's ``mit_*`` models (models/mit.py) against plain SegFormer.

The plain reference (tests/plain_segformer.py: NVlabs' MiT and decoder under
the paper's heads, math attention, float32, no module of the port) and the
port get the same seeded values under the same names, at ``mit_b0`` widths
on 64x128 and 128x128 images, and are compared on:

- the forward, every head's stride-4 logits, in train mode (batch
  statistics and the stochastic-depth and channel-dropout masks drawn from
  the same seed on both sides) and in eval mode (running statistics, no
  masks);
- the port's train step (``make_train_step`` with ``FusedSGDM``, B1/B2 and
  B3 as their plain versions on the CPU) against the reference's two SGDM
  steps: the first step's loss, the first gradient of every leaf (read from
  the momentum, less the weight decay), the change of every leaf over the
  two steps, each by its norm over the larger of the leaf's and the median
  leaf's.

Tolerances (measured on one and on eight CPU threads). In float32 both
sides compute one function in another order: the logits agree to 1.5e-6 of
the largest, so 1e-4 leaves room for the other shapes and seeds and still
fails where a fault moves a logit by a ten-thousandth (the softmax scale
left out moves them by over 10%). The loss agrees to 1e-7 (held at 1e-5),
the leaves to 4e-4 (held at 1e-3: a leaf the hierarchical gates leave with
few pixels moves most). In bfloat16 the port rounds every layer's output
and the reference does not: logits within 2% of the largest (held at 6%),
the first loss within 2.2e-4 (held at 2e-3), the leaves within 1.9% (held
at 6%).
"""

import math
import os
import statistics

import pytest
import torch

import plain_segformer as plain
from iv2019_tpu_torch import bench
from iv2019_tpu_torch.config import Settings, build_argparser
from iv2019_tpu_torch.models import mit
from iv2019_tpu_torch.models.model import build_model, init_model
from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
from iv2019_tpu_torch.train.fused_update import FusedSGDM
from iv2019_tpu_torch.train.state import create_fused_train_state
from iv2019_tpu_torch.train.step import make_train_step, uses_fused_loss

PROBLEM = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "iv2019_tpu_torch", "problem_definitions", "cityscapes", "problem01.json")
LOGIT_KEYS = ("l1_logits", "l2_vehicle_logits", "l2_human_logits")
WIDTHS = plain.WIDTHS["mit_b0"]
HEADS = (14, 7, 3)
SIZES = [(64, 128), (128, 128)]
F32 = dict(logits=1e-4, loss=1e-5, leaf=1e-3)
BF16 = dict(logits=6e-2, loss=2e-3, leaf=6e-2)
LR, MOMENTUM, WD, COEFF = 0.01, 0.9, 0.00017, 0.1
NB = (1, 2, 1)


def _hier(tax) -> dict:
    keys = ("per_pixel_cids2l1_cids", "per_pixel_cids2vehicle_cids", "per_pixel_cids2human_cids",
            "per_bbox_cids2vehicle_cids", "per_bbox_cids2human_cids")
    out = {k: [int(v) for v in getattr(tax, k)] for k in keys}
    out.update(cid_l1_vehicle=int(tax.cid_l1_vehicle), cid_l1_human=int(tax.cid_l1_human))
    return out


def _settings(hw, dtype="float32", mode="train", **kw) -> Settings:
    kw = dict(dict(name_feature_extractor="mit_b0", stride_feature_extractor=4), **kw)
    s = Settings(device="cpu", mode=mode, compute_dtype=dtype, height_feature_extractor=hw[0],
                 width_feature_extractor=hw[1], Nb_per_pixel=NB[0], Nb_per_bbox=NB[1],
                 Nb_per_image=NB[2], Nb=NB[0], Ntrain=16, Ne=1, learning_rate_boundaries=(1,),
                 learning_rate_values=(LR,), momentum=MOMENTUM, regularization_weight=WD,
                 weak_loss_coefficient=COEFF, ema_decay=0.9, **kw)
    return s.finalize() if mode == "train" else s


def _model(s: Settings, params: dict):
    model = build_model(s)
    with torch.no_grad():
        model.load_state_dict(params, strict=True)
    return model


def _params(seed=3):
    return plain.draw_params(plain.param_spec(WIDTHS, HEADS), seed)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def _leaf_gap(got: dict, want: dict) -> tuple:
    norms_g = {k: float(torch.linalg.vector_norm(v.double())) for k, v in got.items()}
    norms_w = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    med = statistics.median(norms_w.values())
    keep = [k for k, v in norms_w.items() if v >= 1e-3 * med]
    gaps = {k: abs(norms_g[k] - norms_w[k]) / max(norms_w[k], med) for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


@pytest.mark.parametrize("name", ["mit_b0", "mit_b5"])
def test_names_and_shapes_are_the_references(name):
    model = build_model(Settings(device="cpu", name_feature_extractor=name,
                                 stride_feature_extractor=4))
    spec = dict(plain.param_spec(plain.WIDTHS[name], HEADS))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == spec
    widths = mit.MIT_WIDTHS[name]
    assert tuple(widths) == tuple(plain.WIDTHS[name])
    if name == "mit_b5":
        # SegFormer-B5 as published: 52 blocks, 81.4M parameters in the
        # encoder, 84.7M with the decoder (and its 768 x 19 classifier)
        base = {k: p.numel() for k, p in model.named_parameters()
                if k.startswith("feature_extractor/base.")}
        enc = sum(n for k, n in base.items() if "decode_head" not in k)
        assert sum(widths.depths) == 52 and 81.4e6 < enc < 81.5e6
        assert 84.6e6 < sum(base.values()) + 768 * 19 + 19 < 84.8e6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_reference(hw, dtype, train):
    torch.manual_seed(0)
    params = _params()
    model = _model(_settings(hw, dtype), params).train(train)
    images = torch.rand(3, *hw, 3) * 2 - 1
    model.seed_stochastic(77)
    with torch.no_grad():
        out = model(images, upsampling_method="no")
        masks = plain.draw_masks(77, 3, WIDTHS, "cpu") if train else None
        ref = plain.forward(params, images, WIDTHS, train=train, masks=masks)
    tol = (F32 if dtype == "float32" else BF16)["logits"]
    for key, want in zip(LOGIT_KEYS, ref):
        got = out[key].permute(0, 3, 1, 2)
        assert got.shape == want.shape == (3, HEADS[LOGIT_KEYS.index(key)],
                                           hw[0] // 4, hw[1] // 4)
        assert _rel(got, want) < tol, (key, _rel(got, want))


def test_the_masks_are_the_references_and_drop_what_they_say():
    """The port draws the reference's masks from a seed; another seed drops
    other branches and moves the logits; eval mode draws none."""
    params = _params()
    model = _model(_settings((64, 128)), params)
    base = model.get_submodule("feature_extractor/base")
    model.seed_stochastic(5)
    keep, channels = base._draw(4, torch.device("cpu"))
    want_keep, want_channels = plain.draw_masks(5, 4, WIDTHS, "cpu")
    assert torch.equal(keep, want_keep) and torch.equal(channels, want_channels)
    # block 0 never drops; the others keep 1 / (1 - p) or drop
    assert torch.all(keep[0] == 1.0)
    p = torch.linspace(0, 0.1, 8)
    for i in range(1, 8):
        kept = 1 / (1 - float(p[i]))
        assert all(v == 0.0 or abs(v - kept) < 1e-6 for v in keep[i].flatten().tolist())
    assert all(v == 0.0 or abs(v - 1 / 0.9) < 1e-6 for v in channels.flatten().tolist())
    assert 0.02 < float((channels == 0).float().mean()) < 0.2
    images = torch.rand(4, 64, 128, 3) * 2 - 1
    with torch.no_grad():
        model.seed_stochastic(5)
        a = model(images, upsampling_method="no")["l1_logits"]
        model.seed_stochastic(6)
        b = model(images, upsampling_method="no")["l1_logits"]
        model.seed_stochastic(5)
        c = model(images, upsampling_method="no")["l1_logits"]
    assert torch.equal(a, c) and not torch.equal(a, b)
    model.eval()
    assert base._draw(4, torch.device("cpu")) == (None, None)


def _program_steps(s: Settings, params: dict, batches: list):
    model = _model(s, params)
    opt = FusedSGDM(s, model)
    state, step = create_fused_train_state(opt), make_train_step(s, fused_opt=opt)
    assert uses_fused_loss(s, model)
    losses = []
    state, metrics = step(state, batches[0])
    losses.append(float(metrics["total"] - metrics["regularization"]))
    grads = {}
    for name, shape, stride, offset in opt.layout:
        m = torch.as_strided(state.opt_state.momentum, shape, stride, offset).clone()
        grads[name] = m - WD * params[name] if name.endswith(".weight") else m
    for b in batches[1:]:
        state, metrics = step(state, b)
    deltas = {n: p.detach() - params[n] for n, p in model.named_parameters()}
    return losses, grads, deltas


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", SIZES)
def test_train_step_matches_the_reference(hw, dtype):
    """Loss, first gradient by leaf and the change over two steps."""
    torch.manual_seed(0)
    params = _params()
    tax = get_taxonomy("cityscapes")
    batches = [bench.train_batch(hw[0], hw[1], *NB, seed=i) for i in range(2)]
    losses, grads, deltas = _program_steps(_settings(hw, dtype), params, batches)
    ref = plain.train_steps(params, batches, WIDTHS, _hier(tax), LR, MOMENTUM, WD, COEFF)
    tol = F32 if dtype == "float32" else BF16
    want = ref["losses"][0]["total"]
    assert abs(losses[0] - want) / abs(want) < tol["loss"], (losses[0], want)
    gap, leaf = _leaf_gap(grads, ref["first_grads"])
    assert gap < tol["leaf"], ("grad", gap, leaf)
    gap, leaf = _leaf_gap(deltas, {k: v - params[k] for k, v in ref["params"].items()})
    assert gap < tol["leaf"], ("delta", gap, leaf)


def test_remat_gives_the_same_gradients():
    """Each MiT block recomputed in the backward: the same masks, the same
    flat gradient bit for bit."""
    params = _params()
    batch = bench.train_batch(64, 128, *NB, seed=4)
    grads = []
    for remat in (False, True):
        s = _settings((64, 128), remat=remat)
        model = _model(s, params)
        assert model.get_submodule("feature_extractor/base").remat == remat
        opt = FusedSGDM(s, model)
        state, step = create_fused_train_state(opt), make_train_step(s, fused_opt=opt)
        step(state, batch)
        grads.append(opt.grads.clone())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("fields,match", [
    (dict(spatial_partitions=2), "spatial_partitions"),
    (dict(fused_block=True), "fused_block"),
    (dict(stride_feature_extractor=8), "output stride 4"),
    (dict(name_feature_extractor="mit_b9"), "unknown name_feature_extractor"),
])
def test_validate_refuses_what_mit_cannot_run(fields, match):
    kw = dict(name_feature_extractor="mit_b5", stride_feature_extractor=4)
    kw.update(fields)
    with pytest.raises(ValueError, match=match):
        _settings((64, 128), **kw)
    with pytest.raises(ValueError, match=match):
        build_model(Settings(device="cpu", **kw))


def test_the_feature_extractor_flag_is_jaxs_and_the_ports_own():
    """The command line's names: the JAX package's, and ``mit_*`` as the
    port's own (as ``--device`` is)."""
    from iv2019_tpu.config import build_argparser as jax_build_argparser

    def choices(parser):
        action = next(a for a in parser._actions if a.dest == "name_feature_extractor")
        return list(action.choices)

    for mode in ("train", "eval", "predict"):
        port, jax = choices(build_argparser(mode)), choices(jax_build_argparser(mode))
        assert port == jax + ["mit_b0", "mit_b5"]


def test_init_model_draws_segformers_initial_values():
    model = init_model(build_model(_settings((64, 128))), torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    q = named["feature_extractor/base.block3.1.attn.q.weight"].detach()
    # timm's trunc_normal_(std=.02) cuts at +-2 absolute: no cut in practice
    assert abs(float(q.std()) - 0.02) < 0.003 and float(q.abs().max()) > 0.04
    assert float(named["feature_extractor/base.block3.1.attn.q.bias"].detach().abs().max()) == 0.0
    dw = named["feature_extractor/base.block1.0.mlp.dwconv.dwconv.weight"].detach()
    assert abs(float(dw.std()) - math.sqrt(2.0 / 9)) < 0.05
    assert torch.all(named["feature_extractor/base.norm4.scale"] == 1.0)


def test_train_and_evaluate_command_lines_run_mit(tmp_path):
    """``train_cli`` trains ``mit_b0`` for two steps on the CPU and
    ``evaluate_cli`` evaluates its checkpoint, reading the model from
    settings.txt."""
    from iv2019_tpu_torch import evaluate_cli, train_cli

    log = tmp_path / "log"
    train_cli.main([str(log), "cityscapes", "--synthetic_data", "--device", "cpu",
                    "--name_feature_extractor", "mit_b0", "--stride_feature_extractor", "4",
                    "--compute_dtype", "float32", "--height_feature_extractor", "64",
                    "--width_feature_extractor", "128", "--Nb_per_pixel", "1",
                    "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
                    "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
                    "--input_seed", "3"])
    settings = (log / "settings.txt").read_text()
    assert " : name_feature_extractor : mit_b0" in settings
    assert (log / "checkpoints" / "2" / "state.pt").exists()
    evaluate_cli.main([str(log), "2", PROBLEM, "--synthetic_data", "--device", "cpu",
                       "--compute_dtype", "float32", "--height_feature_extractor", "64",
                       "--width_feature_extractor", "128", "--Nb", "2"])
    assert (log / "eval_00" / "all_metrics.txt").exists()

