"""Model export: the predict forward as a torch.export program and an
AOTInductor package.

Port of iv2019_tpu/tools/export_model.py. The JAX package closes the
weights into a jitted forward and writes StableHLO, which its C++ PJRT
loader compiles and runs. Here the portable program is a
``torch.export`` ExportedProgram and the compiled one an AOTInductor
package, which serving/aoti_loader.cc loads and runs with no Python
(``iv2019_tpu_torch.serving``).

Usage:
  python -m iv2019_tpu_torch.tools.export_model LOG_DIR PROBLEM_DEF OUT_DIR \\
      [--height 512 --width 1024] [--wire_u8] [--fused_block] [--device cpu] \\
      [--ckpt_path STEP|PATH/STEP|model.npz] [--restore_emas] \\
      [--eval_flip] [--eval_scales S ...] [--eval_size H W [--sliding_window]]

Writes:
  OUT_DIR/forward.pt2        the ExportedProgram (torch.export.save)
  OUT_DIR/forward.graph.txt  its printed graph (inspection; the counterpart
                             of forward.hlo.txt)
  OUT_DIR/forward.aoti.pt2   the AOTInductor package for the model's device

The weights are constants of the program. Everything computed from them
alone (the BatchNorm folding of the fused units, the eval BatchNorm's
``rsqrt(var + eps) * scale``, the casts of the conv kernels to the compute
dtype, the weight layouts of the fused units) is evaluated once at export
(``fold_weights``), so no such operation runs per request
(``weight_only_nodes`` finds any that would). On the card each eval
BatchNorm is one ``iv2019::bn_eval.folded`` node (ops/fused_bn.py), which
reads its folded table (mean, factor, bias) and launches kernel N3; on the
CPU it is the plain chain. With ``--fused_block`` the fused units stay in
the program as ``iv2019::fused_bottleneck`` and
``iv2019::fused_bottleneck_ct`` nodes (ops/fused_block.py), which launch
the B4/B5 kernels on the card. A process that runs the program or the
package loads the operator library first (``fused_block.ops_library``, the
loader's ``ops=``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
from torch import nn

__all__ = ["ServedForward", "compile_package", "export_program", "fold_weights", "main",
           "op_nodes", "weight_only_nodes"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# package metadata the C++ loader checks a request's input against
INPUT_DTYPE_KEY = "iv2019.input_dtype"
INPUT_SHAPE_KEY = "iv2019.input_shape"


class ServedForward(nn.Module):
    """images -> (decisions, l1_probabilities), the served signature.

    ``wire_u8``: the input is uint8 NHWC, normalized to [-1, 1) on the
    device as the reference's from_0_1_to_m1_1 (input_pipelines/utils.py),
    and output 0 is the decisions as uint8: 4x fewer bytes each way."""

    def __init__(self, model: nn.Module, predict_fn, wire_u8: bool):
        super().__init__()
        self.model, self.predict_fn, self.wire_u8 = model, predict_fn, wire_u8

    def forward(self, images):
        if self.wire_u8:
            images = images.to(torch.float32) / 255.0 * 2.0 - 1.0
        preds = self.predict_fn(images) if self.predict_fn else self.model(images)
        decisions = preds["decisions"]
        if self.wire_u8:
            decisions = decisions.to(torch.uint8)
        return decisions, preds["l1_probabilities"]


def _attr(module: nn.Module, target: str):
    for name in target.split("."):
        module = getattr(module, name)
    return module


# views: no arithmetic and no copy, left in the program on a folded constant
_VIEWS = (torch.ops.aten.permute.default,)


def _dense(value: torch.Tensor):
    """(``value``'s elements contiguous in its memory order, the permutation
    that views them as ``value``): a constant of any dense layout (a
    channels_last kernel) is stored contiguous and read back as a view of
    the same layout, so the package writers never meet a tensor that covers
    its storage out of order (which they warn they may save wrongly off the
    CPU)."""
    order = sorted(range(value.dim()), key=lambda d: (-value.stride(d), d))
    stored = value.detach().permute(order).clone(memory_format=torch.contiguous_format)
    return stored, [order.index(d) for d in range(value.dim())]


def fold_weights(gm: torch.fx.GraphModule) -> int:
    """Evaluate, once, every node of ``gm`` (an exported program's module,
    weights as ``get_attr``) computed from weights alone, and read its value
    as a buffer instead (stored contiguous, behind a ``permute`` view where
    its layout is another, ``_dense``); drop the weights nothing reads any
    more. Nodes that read no tensor (constructors) are left to the
    compiler. Returns the number of nodes folded."""
    values = {}
    for node in list(gm.graph.nodes):
        if node.op == "get_attr":
            values[node] = _attr(gm, node.target)
        elif (node.op == "call_function" and node.all_input_nodes
              and all(n in values for n in node.all_input_nodes)):
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), values.__getitem__)
            out = node.target(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                values[node] = out
            elif out is None and not node.users:
                gm.graph.erase_node(node)  # a check of a weight's metadata, which held
    folded = 0
    for node in list(gm.graph.nodes):
        if node.op != "call_function" or node not in values:
            continue
        if all(user in values for user in node.users):
            continue  # read only by nodes folded themselves
        name = f"_folded{folded}"
        stored, order = _dense(values[node])
        gm.register_buffer(name, stored)
        with gm.graph.inserting_before(node):
            const = gm.graph.get_attr(name)
            if order != sorted(order):
                const = gm.graph.call_function(torch.ops.aten.permute.default, (const, order))
        node.replace_all_uses_with(const)
        folded += 1
    gm.graph.eliminate_dead_code()
    read = {n.target for n in gm.graph.nodes if n.op == "get_attr"}
    for name, _ in [*gm.named_parameters(), *gm.named_buffers()]:
        if name not in read:
            owner, _, leaf = name.rpartition(".")
            delattr(_attr(gm, owner) if owner else gm, leaf)
    gm.recompile()
    return folded


def weight_only_nodes(program: torch.export.ExportedProgram) -> list[str]:
    """Operations of ``program`` computed from its weights and constants
    alone, which would run per request though they give the same values
    every time; ``fold_weights`` leaves none."""
    sig = program.graph_signature
    const = {n for n in program.graph.nodes if n.op == "placeholder"
             and n.name not in sig.user_inputs}
    found = []
    for node in program.graph.nodes:
        if (node.op == "call_function" and node.all_input_nodes
                and all(n in const for n in node.all_input_nodes)):
            const.add(node)
            if node.target not in _VIEWS:
                found.append(node.format_node())
    return found


def op_nodes(program: torch.export.ExportedProgram) -> dict[str, int]:
    """How many nodes of ``program`` call each operator of the library:
    the fused units and ``bn_eval`` (either form)."""
    counts = {"fused_bottleneck": 0, "fused_bottleneck_ct": 0, "bn_eval": 0}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith("iv2019::"):
            counts[name.split("::")[1].split(".")[0]] += 1
    return counts


def _links_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        source = os.path.join(tmp, "omp.cpp")
        with open(source, "w") as f:
            f.write("int main() { return 0; }\n")
        try:
            proc = subprocess.run([cxx, "-fopenmp", source, "-o", os.path.join(tmp, "omp")],
                                  capture_output=True)
        except OSError:  # no such compiler
            return False
        return proc.returncode == 0


def package_compiler() -> str:
    """The C++ compiler AOTInductor builds a package with: the first of
    ``$CXX`` and ``g++`` on the path that links an OpenMP program, which
    the package's wrapper is (Inductor passes ``-fopenmp``). Raises where
    neither does."""
    for cxx in (os.environ.get("CXX"), shutil.which("g++")):
        if cxx and _links_openmp(cxx):
            return cxx
    raise RuntimeError("no C++ compiler that links -fopenmp: set CXX to one")


def compile_package(program_path: str, package_path: str, metadata: dict) -> float:
    """The AOTInductor package of the saved program ``program_path``, for
    the device its weights are on, compiled in this process; returns the
    seconds the compile took. ``metadata`` goes into the package (the input
    dtype and shape, which the C++ loader checks frames against)."""
    from torch._inductor import aoti_compile_and_package

    from iv2019_tpu_torch.ops.fused_block import ops_library

    ops_library()  # the program calls the library's operators
    program = torch.export.load(program_path)
    t0 = time.perf_counter()
    # emulate_precision_casts: round where the eager program rounds to bf16,
    # so that the package computes the eager program's values
    aoti_compile_and_package(program, package_path=package_path, inductor_configs={
        "aot_inductor.metadata": metadata, "emulate_precision_casts": True,
        "cpp.cxx": (package_compiler(),)})
    return time.perf_counter() - t0


def _compile_apart(program_path: str, package_path: str, metadata: dict) -> float:
    """``compile_package`` in a Python process of its own. Compiled in the
    process that had built and run the model, the flagship's CUDA package
    once computed other values than its program (torch 2.11 on the H100: 8%
    of the decisions equal, the same on every run and with blocking
    launches); compiled apart, it gives the program's values. The cause is
    not known, and it did not come back when looked for: compiled in a
    process that had built and run the flagship, with TF32 off and every
    kernel library loaded through ``ctypes``, the package gave every eager
    decision, and so it did with PyTorch's TF32 defaults restored before the
    compile, after ``torch._dynamo.reset()`` with a fresh Inductor cache,
    compiled before the eager run and the ``ctypes`` loads, after a profiled
    full-width train step, and after a CUDA graph's capture. Only a compile
    without ``emulate_precision_casts`` departed from eager. Until the fault
    is found the compile stays apart."""
    code = ("import json, sys\n"
            "from iv2019_tpu_torch.tools.export_model import compile_package\n"
            "print(json.dumps(compile_package(*json.loads(sys.argv[1]))))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (_ROOT, env.get("PYTHONPATH"))))
    proc = subprocess.run([sys.executable, "-c", code,
                           json.dumps([program_path, package_path, metadata])],
                          capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"the AOTInductor compile of {program_path} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return float(proc.stdout.strip().splitlines()[-1])


def export_program(
    model: nn.Module, input_shape, out_dir: str, wire_u8: bool = False, predict_fn=None,
    package: bool = True,
) -> dict:
    """Export the forward of ``model`` (in eval mode, on the device the
    package is for) at ``input_shape`` (N, H, W, 3).

    ``predict_fn(images) -> predictions dict`` replaces the plain forward:
    the sliding-window / TTA predict program (``make_predict_step(...)
    .__wrapped__``), static in shape and so one program too. ``package``
    False skips the AOTInductor compile. Returns the paths written, and the
    seconds the export and the compile took under ``seconds``.
    """
    os.makedirs(out_dir, exist_ok=True)
    if model.training:
        raise ValueError("export_program takes a model in eval mode (model.eval())")
    device = next(model.parameters()).device
    example = torch.zeros(tuple(input_shape), device=device,
                          dtype=torch.uint8 if wire_u8 else torch.float32)
    forward = ServedForward(model, predict_fn, wire_u8)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(forward, (example,), strict=False)
        module = program.module()
        fold_weights(module)
        program = torch.export.export(module, (example,), strict=False)
    seconds = {"export": time.perf_counter() - t0}
    leftover = weight_only_nodes(program)
    if leftover:
        raise AssertionError(f"weight arithmetic left in the program: {leftover[:5]}")
    paths = {"program": os.path.join(out_dir, "forward.pt2"),
             "graph": os.path.join(out_dir, "forward.graph.txt")}
    with open(paths["graph"], "w") as f:
        f.write(str(program))
    torch.export.save(program, paths["program"])
    if package:
        paths["package"] = os.path.join(out_dir, "forward.aoti.pt2")
        metadata = {INPUT_DTYPE_KEY: "uint8" if wire_u8 else "float32",
                    INPUT_SHAPE_KEY: ",".join(str(int(d)) for d in input_shape)}
        seconds["compile"] = _compile_apart(paths["program"], paths["package"], metadata)
    paths["seconds"] = seconds
    return paths


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log_dir")
    p.add_argument("training_problem_def_path")
    p.add_argument("out_dir")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--restore_emas", action="store_true")
    p.add_argument("--wire_u8", action="store_true", help="uint8 wire signature (serving)")
    p.add_argument("--eval_size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="export a native-resolution program at this input size (the (hf, wf) "
                        "training size stays --height --width)")
    p.add_argument("--sliding_window", action="store_true",
                   help="export the sliding-window predict program: tile eval_size with "
                        "(height, width) windows, stitch per-head probabilities, fuse decisions")
    p.add_argument("--window_overlap", type=float, default=0.5)
    p.add_argument("--window_blend", type=str, default="uniform", choices=["uniform", "gaussian"])
    p.add_argument("--eval_flip", action="store_true")
    p.add_argument("--eval_scales", type=float, nargs="*", default=[1.0])
    p.add_argument("--fused_block", action="store_true",
                   help="the fused identity units as iv2019::fused_bottleneck* nodes (B4/B5); "
                        "a process that runs the package loads the operator library first")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="the device the package is compiled for")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="a step of the training run in LOG_DIR, a path ending in one, or a "
                        "converted model.npz (default: the latest checkpoint)")
    return p


def main(argv):
    args = build_argparser().parse_args(argv)

    from iv2019_tpu_torch.config import Settings, resolve_dataset_name, resolve_trained_model
    from iv2019_tpu_torch.models.model import build_model
    from iv2019_tpu_torch.system import SemanticSegmentation, restore_variables

    settings = Settings(
        mode="predict",
        log_dir=args.log_dir,
        training_problem_def_path=args.training_problem_def_path,
        height_feature_extractor=args.height,
        width_feature_extractor=args.width,
        restore_emas=args.restore_emas,
        eval_size=tuple(args.eval_size) if args.eval_size else None,
        sliding_window=args.sliding_window,
        window_overlap=args.window_overlap,
        window_blend=args.window_blend,
        eval_flip=args.eval_flip,
        eval_scales=tuple(args.eval_scales),
        fused_block=args.fused_block,
        device=args.device,
        ckpt_path=args.ckpt_path,
    )
    settings = resolve_trained_model(resolve_dataset_name(settings, None), argv)
    system = SemanticSegmentation({}, model_fn=build_model, settings=settings)
    s = system.settings.replace(mode="predict")
    model = build_model(s)
    print(f"restored {restore_variables(model, s)}")

    predict_fn = None
    in_hw = (args.height, args.width)
    ensembled = s.sliding_window or s.eval_flip or tuple(s.eval_scales) != (1.0,)
    if ensembled or s.eval_size:
        # the whole predict program (window stitching / TTA ensembling) is
        # one static-shape program: export it instead of the bare forward;
        # plain eval_size needs no wrapper (fully convolutional)
        in_hw = s.eval_size or in_hw
        if ensembled:
            from iv2019_tpu_torch.train.step import make_predict_step

            predict_fn = make_predict_step(s, model=model).__wrapped__

    paths = export_program(model, (1, *in_hw, 3), args.out_dir, wire_u8=args.wire_u8,
                           predict_fn=predict_fn)
    print(json.dumps(paths))
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
