"""The port's model export (tools/export_model.py) against JAX, on the CPU.

The exported program (``torch.export.load(...).module()``) of the small f32
model (torch_parity.py, the JAX model's weights) is held to JAX's
``model.apply`` on the same seeded images, with the bar of
tests/test_torch_model.py: decisions equal on >= 99.9% of pixels,
``l1_probabilities`` within 1e-4 absolute. The same for the ``wire_u8``
program (u8 in, normalized on the device; JAX applied to
``u8 / 255 * 2 - 1``), and for an ensembled (flip, scales 0.75 and 1.0) and
a windowed program against JAX's ``make_predict_step``. Against the eager
port the program is exact (the same operations, the weight arithmetic done
once at export). The JAX export's signature checks are mirrored
(tests/test_serving.py::test_export_wire_u8_signature,
tests/test_resume_export.py::test_stablehlo_export).

The operator library (csrc/torch_ops.cpp) builds here with ``g++``, the
schemas only, and the CLI exports a bf16 ``--fused_block`` program at
128x128 from a small training run of the port: its graph holds the three
fused units of the small stack as ``iv2019::fused_bottleneck`` nodes (and no
``iv2019::bn_eval`` node: a CPU export keeps the eval BatchNorm's plain
chain, its factor folded; the card's exports are held in
tests/test_torch_kernels_gpu.py), and its AOTInductor
package, run in this process, equals the eager fused forward (decisions on
every pixel, probabilities within 1e-6: the package rounds to bf16 where
the eager program does). That is this file's one AOTInductor compile.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iv2019_tpu.config import Settings as JaxSettings
from iv2019_tpu.train import step as jstep
from iv2019_tpu_torch.config import Settings as TorchSettings
from iv2019_tpu_torch.models import resnet
from iv2019_tpu_torch.ops import fused_block as fb
from iv2019_tpu_torch.tools import export_model as em
from iv2019_tpu_torch.train import step as tstep
from torch_parity import (
    SMALL_BLOCKS,
    SMALL_FDIMS,
    SMALL_HW,
    jax_small_model,
    small_images,
    small_variables,
    threads,
    to_numpy,
    torch_small_model,
)

PROBLEM = "iv2019_tpu/problem_definitions/cityscapes/problem01.json"
PORT_PROBLEM = "iv2019_tpu_torch/problem_definitions/cityscapes/problem01.json"
TTA = dict(eval_scales=(0.75, 1.0), eval_flip=True)
WINDOWS = dict(height_feature_extractor=32, width_feature_extractor=48, eval_size=(48, 80),
               sliding_window=True)
PROGRAMS = ("plain", "wire_u8", "ensembled", "windowed")


def _u8_images(seed, hw=SMALL_HW):
    return np.random.RandomState(seed).randint(0, 256, (1, *hw, 3)).astype(np.uint8)


def _settings(**kw):
    common = dict(per_pixel_dataset_name="cityscapes", height_feature_extractor=64,
                  width_feature_extractor=64, compute_dtype="float32",
                  training_problem_def_path=PROBLEM)
    common.update(kw)
    return JaxSettings(**common), TorchSettings(device="cpu", **common)


def _export(name, model, tmp):
    """Export program ``name`` of ``model`` (no package); returns (paths,
    the program's input, JAX's predictions on the same images)."""
    variables = small_variables()
    jmodel = jax_small_model()
    if name in ("plain", "wire_u8"):
        images = small_images(seed=4)
        x = images
        if name == "wire_u8":
            x = _u8_images(seed=4)
            images = x.astype(np.float32) / 255.0 * 2.0 - 1.0
        want = jax.jit(jmodel.apply)(variables, jnp.asarray(images))
        paths = em.export_program(model, x.shape, str(tmp / name), wire_u8=name == "wire_u8",
                                  package=False)
        return paths, x, want
    kw = TTA if name == "ensembled" else WINDOWS
    hw = (64, 96) if name == "ensembled" else WINDOWS["eval_size"]
    js, ts = _settings(**kw)
    x = small_images(seed=5, hw=hw)
    want = jstep.make_predict_step(js, model=jmodel)(
        variables["params"], variables["batch_stats"], jnp.asarray(x))
    step = tstep.make_predict_step(ts, model=model)
    paths = em.export_program(model, x.shape, str(tmp / name), predict_fn=step.__wrapped__,
                              package=False)
    return paths, x, want


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (paths, loaded program, input, JAX predictions, the eager
    port's (decisions, l1_probabilities))."""
    threads()
    tmp = tmp_path_factory.mktemp("export")
    model = torch_small_model(small_variables())
    out = {}
    for name in PROGRAMS:
        paths, x, want = _export(name, model, tmp)
        program = torch.export.load(paths["program"])
        forward = em.ServedForward(model, None, name == "wire_u8")
        if name in ("ensembled", "windowed"):
            kw = TTA if name == "ensembled" else WINDOWS
            forward.predict_fn = tstep.make_predict_step(_settings(**kw)[1], model=model)
        with torch.no_grad():
            eager = forward(torch.from_numpy(x))
        out[name] = (paths, program, x, want, eager)
    return out


@pytest.mark.parametrize("name", PROGRAMS)
def test_exported_decisions_match_jax(exported, name):
    _, program, x, want, _ = exported[name]
    got = to_numpy(program.module()(torch.from_numpy(x))[0])
    want = np.asarray(want["decisions"])
    assert got.shape == want.shape
    assert got.dtype == (np.uint8 if name == "wire_u8" else np.int32)
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("name", PROGRAMS)
def test_exported_probabilities_match_jax(exported, name):
    _, program, x, want, _ = exported[name]
    got = to_numpy(program.module()(torch.from_numpy(x))[1])
    want = np.asarray(want["l1_probabilities"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", PROGRAMS)
def test_exported_program_equals_eager_port(exported, name):
    """The same operations as the eager port, the weight arithmetic done
    once at export: equal decisions, probabilities to f32 rounding."""
    _, program, x, _, eager = exported[name]
    got = program.module()(torch.from_numpy(x))
    assert torch.equal(got[0], eager[0])
    torch.testing.assert_close(got[1], eager[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", PROGRAMS)
def test_no_weight_arithmetic_per_request(exported, name):
    """Nothing computed from the weights alone is left in the program: no
    BatchNorm rsqrt, no weight cast; every weight is read as it is stored."""
    paths, program, _, _, _ = exported[name]
    assert em.weight_only_nodes(program) == []
    text = open(paths["graph"]).read()
    assert "rsqrt" not in text
    # the eval BatchNorms of the small model, read as folded constants
    assert len(program.state_dict) > 0
    assert all(k.startswith("_folded") for k in program.state_dict)


def test_export_wire_u8_signature(exported):
    """wire_u8: u8 input, u8 output 0, normalization on the device."""
    paths, program, x, _, _ = exported["wire_u8"]
    (user_input,) = [n for n in program.graph.nodes if n.op == "placeholder"
                     and n.name in program.graph_signature.user_inputs]
    assert user_input.meta["val"].dtype == torch.uint8
    assert tuple(user_input.meta["val"].shape) == x.shape
    out = program.module()(torch.from_numpy(x))
    assert out[0].dtype == torch.uint8 and tuple(out[0].shape) == x.shape[:3]
    assert out[1].dtype == torch.float32
    text = open(paths["graph"]).read()
    assert "torch.uint8" in text and "255.0" in text  # the input's cast and scale


def test_export_writes_files(exported):
    """The counterpart of test_stablehlo_export: the program and its graph."""
    import os

    paths, program, _, _, _ = exported["plain"]
    assert os.path.getsize(paths["program"]) > 100_000
    text = open(paths["graph"]).read()
    assert "aten.conv2d" in text and "ExportedProgram" in text
    assert os.path.getsize(paths["graph"]) > 10_000
    assert "package" not in paths and paths["seconds"]["export"] > 0


def test_export_refuses_a_model_in_train_mode(tmp_path):
    model = torch_small_model(small_variables()).train()
    with pytest.raises(ValueError, match="eval mode"):
        em.export_program(model, (1, *SMALL_HW, 3), str(tmp_path), package=False)


def test_fold_weights_evaluates_weight_arithmetic_once():
    """A module whose forward scales and casts its weight: folding leaves
    one constant, already scaled and cast, and the same outputs."""

    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
            self.register_buffer("var", torch.full((2,), 4.0))

        def forward(self, x):
            w = (self.weight * torch.rsqrt(self.var)[:, None]).to(torch.float64)
            return x.to(torch.float64) @ w.t()

    x = torch.ones(4, 3)
    program = torch.export.export(Scaled(), (x,), strict=False)
    assert em.weight_only_nodes(program)  # rsqrt, mul, cast run per call
    gm = program.module()
    assert em.fold_weights(gm) == 1
    folded = torch.export.export(gm, (x,), strict=False)
    assert em.weight_only_nodes(folded) == []
    assert [v.dtype for v in folded.state_dict.values()] == [torch.float64]
    torch.testing.assert_close(folded.module()(x), Scaled()(x))


# ------------------------------------------------------------- operator library


@pytest.fixture(scope="module")
def ops_path():
    return fb.ops_library()


def test_op_schema_registered(ops_path):
    for name in fb.OP_NAMES:
        schema = str(getattr(torch.ops.iv2019, name).default._schema)
        assert schema == (f"iv2019::{name}(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
                          "Tensor w3, Tensor b3, int rate, int[] plan) -> Tensor")


@pytest.mark.parametrize("overload,args", [
    ("default", "Tensor x, Tensor mean, Tensor var, Tensor scale, Tensor bias, float epsilon, "
                "Tensor? residual, bool relu"),
    ("folded", "Tensor x, Tensor table, Tensor? residual, bool relu")])
def test_bn_eval_schema_registered(ops_path, overload, args):
    schema = getattr(torch.ops.iv2019.bn_eval, overload)._schema
    name = "bn_eval" if overload == "default" else "bn_eval.folded"
    assert str(schema) == f"iv2019::{name}({args}) -> Tensor"


def test_op_library_has_no_cuda_implementation_here(ops_path):
    """Without CUDA the library is the schemas alone; its launch counter
    reads 0 for the three operators and -1 for any other index."""
    lib = ctypes.CDLL(ops_path)
    lib.iv_op_launches.restype = ctypes.c_int64
    assert lib.iv_op_has_cuda() == 0
    assert [lib.iv_op_launches(i) for i in (0, 1, 2, 3)] == [0, 0, 0, -1]


def _norm_case(dtype, c=14, seed=0):
    """x and a residual (channels_last), running statistics and f32
    parameters of an eval-mode norm."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    x = (t(2, c, 5, 7) * 2).to(dtype).contiguous(memory_format=torch.channels_last)
    residual = t(2, c, 5, 7).to(dtype).contiguous(memory_format=torch.channels_last)
    return x, residual, t(c) * 0.3, t(c).abs() + 0.5, t(c).abs() + 0.5, t(c) * 0.2


@pytest.mark.parametrize("folded", [False, True])
def test_bn_eval_fake_implementation_gives_x_layout(ops_path, folded):
    """Both forms trace to x's shape, type and channels_last strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        x, residual, mean, var, scale, bias = [mode.from_tensor(a)
                                               for a in _norm_case(torch.bfloat16)]
        if folded:
            out = torch.ops.iv2019.bn_eval.folded(x, torch.stack([mean, scale, bias]), residual,
                                                  True)
        else:
            out = torch.ops.iv2019.bn_eval(x, mean, var, scale, bias, 1e-5, residual, True)
    assert out.shape == x.shape and out.dtype == torch.bfloat16 and out.stride() == x.stride()


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_cpu_export_keeps_the_plain_norm_chain_folded(ops_path, layout):
    """Under torch.export an eval-mode Norm of a CPU tensor (a strided
    residual and a ReLU with it) is the plain chain, not the operator: its
    factor and every weight it reads folded to constants, nothing computed
    from the weights per request, the eager bits, no launch counted."""
    from iv2019_tpu_torch.models.layers import Norm
    from iv2019_tpu_torch.ops import fused_bn as fbn

    class Unit(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.norm = Norm(14).eval()

        def forward(self, x, shortcut):
            return self.norm(x, shortcut[:, :, ::2, ::2], True)

    unit = Unit()
    x, residual, mean, var, scale, bias = _norm_case(torch.bfloat16)
    with torch.no_grad():
        for name, value in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
            getattr(unit.norm, name).copy_(value)
        if layout == "contiguous":
            x = x.contiguous()
        shortcut = torch.cat([residual, residual], 3).repeat(1, 1, 2, 1)
        before = fbn.fused_bn_eval.launches
        program = torch.export.export(unit, (x, shortcut), strict=False)
        module = program.module()
        assert em.fold_weights(module) > 0
        program = torch.export.export(module, (x, shortcut), strict=False)
        want = unit(x, shortcut)
    assert em.op_nodes(program)["bn_eval"] == 0
    assert em.weight_only_nodes(program) == []
    assert all(k.startswith("_folded") for k in program.state_dict)
    assert torch.equal(program.module()(x, shortcut), want)
    assert torch.equal(want, fbn.batch_norm_eval_plain(x, mean, var, scale, bias, 1e-5,
                                                       shortcut[:, :, ::2, ::2], True))
    assert fbn.fused_bn_eval.launches == before


def _unit(seed=0, c=128, m=128, hw=(8, 8)):
    rng = np.random.RandomState(seed)
    bf = torch.bfloat16

    def t(shape, scale, dtype=bf):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32).to(dtype)

    return (t((1, *hw, c), 1.0), t((c, m), 0.1), t((m,), 0.1, torch.float32), t((3, 3, m, m), 0.03),
            t((m,), 0.1, torch.float32), t((m, c), 0.1), t((c,), 0.1, torch.float32))


@pytest.mark.parametrize("name", fb.OP_NAMES)
def test_op_cpu_implementation_is_the_plain_version(ops_path, name):
    args = _unit()
    got = getattr(torch.ops.iv2019, name)(*args, 2, fb.op_plan(args[0], args[1], 2))
    assert torch.equal(got, fb.bottleneck_plain(*args, rate=2))


def test_op_fake_implementation_gives_the_output_shape(ops_path):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        args = [mode.from_tensor(a) for a in _unit(hw=(16, 24))]
        out = torch.ops.iv2019.fused_bottleneck(*args, 1, [64, 6, 128, 6, 0, 0])
    assert out.shape == (1, 16, 24, 128) and out.dtype == torch.bfloat16


def test_op_plan_is_the_kernels_plan():
    x = torch.empty(1, 64, 128, 2048, dtype=torch.bfloat16)
    w1 = torch.empty(2048, 512, dtype=torch.bfloat16)
    p = fb._plan(1, 64, 128, 2048, 512, 4)
    assert fb.op_plan(x, w1, 4) == [p.tile1, p.stages1, p.nc, p.stages2, p.smem1, p.smem2]


def test_export_keeps_the_fused_unit_as_one_node(ops_path):
    """Under torch.export a CPU tensor goes through the operator: the unit
    is one node, whose CPU implementation is the plain version; no launch
    is counted."""

    class Unit(torch.nn.Module):
        def forward(self, *args):
            return fb.fused_bottleneck_ct(*args, rate=1)

    args = _unit(seed=1)
    before = fb.fused_bottleneck_ct.launches
    program = torch.export.export(Unit(), args, strict=False)
    assert em.op_nodes(program) == {"fused_bottleneck": 0, "fused_bottleneck_ct": 1,
                                    "bn_eval": 0}
    assert torch.equal(program.module()(*args), fb.bottleneck_plain(*args, rate=1))
    assert fb.fused_bottleneck_ct.launches == before


# ------------------------------------------------------------- the CLI

TRAIN_ARGS = ["cityscapes", "--synthetic_data", "--device", "cpu", "--compute_dtype", "float32",
              "--height_feature_extractor", "64", "--width_feature_extractor", "64",
              "--feature_dims_decreased", str(SMALL_FDIMS), "--Nb_per_pixel", "1",
              "--Nb_per_bbox", "1", "--Nb_per_image", "1", "--Ntrain", "2", "--Ne", "1",
              "--learning_rate_boundaries", "1", "--learning_rate_values", "0.01",
              "--input_seed", "3", "--save_checkpoints_steps", "1"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Two steps of the port's train_cli at 64x64, then the export CLI,
    fused, at 128x128 on the CPU (bf16, three fused units); returns (paths,
    the eager fused model restored from the run, a u8 frame)."""
    from iv2019_tpu_torch import train_cli
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import restore_variables

    threads()
    root = tmp_path_factory.mktemp("cli")
    log = root / "log"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(resnet.FEATURE_EXTRACTOR_BLOCKS, "resnet_v1_50", SMALL_BLOCKS)
        train_cli.main([str(log), *TRAIN_ARGS])
        paths = em.main([str(log), PORT_PROBLEM, str(root / "out"), "--fused_block",
                         "--wire_u8", "--height", "128", "--width", "128", "--device", "cpu"])
        settings = TorchSettings(
            mode="predict", log_dir=str(log), training_problem_def_path=PORT_PROBLEM,
            height_feature_extractor=128, width_feature_extractor=128, fused_block=True,
            device="cpu", feature_dims_decreased=SMALL_FDIMS).finalize()
        model = build_model(settings)
    restore_variables(model, settings)
    return paths, model, _u8_images(seed=6)


def _eager_fused(model, frame):
    with torch.no_grad():
        return em.ServedForward(model, None, True)(torch.from_numpy(frame))


def test_cli_writes_the_program_graph_and_package(cli):
    import os

    paths = cli[0]
    assert {"program", "graph", "package"} <= set(paths)
    assert all(os.path.getsize(paths[k]) > 10_000 for k in ("program", "graph", "package"))
    assert paths["seconds"]["compile"] > 0


def test_cli_graph_holds_the_fused_units(cli):
    """SMALL_BLOCKS at 128x128: block2/unit_2, block3/unit_1 and unit_2
    pass the full-window rule (tests/test_torch_model.py); a CPU export's
    other norms are the plain chain, folded (no bn_eval node)."""
    program = torch.export.load(cli[0]["program"])
    assert em.op_nodes(program) == {"fused_bottleneck": 3, "fused_bottleneck_ct": 0,
                                    "bn_eval": 0}
    assert open(cli[0]["graph"]).read().count("torch.ops.iv2019.fused_bottleneck.default") == 3
    assert em.weight_only_nodes(program) == []


def test_cli_program_equals_the_eager_fused_forward(cli):
    paths, model, frame = cli
    want = _eager_fused(model, frame)
    got = torch.export.load(paths["program"]).module()(torch.from_numpy(frame))
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)


def test_cli_package_equals_the_eager_fused_forward(cli):
    paths, model, frame = cli
    want = _eager_fused(model, frame)
    got = torch._inductor.aoti_load_package(paths["package"])(torch.from_numpy(frame))
    assert got[0].dtype == torch.uint8
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=0)


def test_cli_default_device_is_the_card(cli, tmp_path):
    """No --device: the card, which this machine lacks: refused, no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    log = cli[0]["program"].rsplit("/out/", 1)[0] + "/log"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        em.main([log, PORT_PROBLEM, str(tmp_path), "--height", "128", "--width", "128"])


def test_package_compiler_skips_a_cxx_that_cannot_link_openmp(monkeypatch, tmp_path):
    """A $CXX whose OpenMP does not link (the package's wrapper needs it)
    gives way to g++ on the path; one that links is taken; neither raises."""
    import shutil

    broken = tmp_path / "cxx"
    broken.write_text("#!/bin/sh\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    assert em.package_compiler() == shutil.which("g++")
    monkeypatch.setenv("CXX", shutil.which("g++"))
    assert em.package_compiler() == shutil.which("g++")
    monkeypatch.setenv("CXX", str(tmp_path / "missing"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="fopenmp"):
        em.package_compiler()
