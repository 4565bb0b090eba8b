"""BatchNorm on the card: train mode with the classic two-reduction backward
(kernels N1, N2), and eval mode on the running statistics (kernel N3).

Port of iv2019_tpu/ops/fused_bn.py, the JAX package's ``bn_impl="fused"``:
per channel over every non-channel axis, ``mean = E[x]``, ``var = max(0,
E[x^2] - E[x]^2)`` (flax's single-pass form, not Welford),
``y = (x - mean) * (rstd * scale) + bias`` with ``rstd = rsqrt(var + eps)``,
and the backward

    dbeta  = sum(dy)
    dgamma = sum(dy * xhat),  xhat = (x - mean) * rstd
    dx     = (scale * rstd) * (dy - dbeta / m - xhat * (dgamma / m))

instead of autodiff through the statistics. A channel of constant input
takes the unclamped branch, as JAX's does (fused_bn.py:25-29).

Tensors are the port's NCHW (the statistics run over N, H and W). JAX's
Norm casts the compute-type activation to f32 before its custom VJP, so
this module computes that function on the activation as it is: bf16 or f32
in, every statistic and sum in f32 (on the card: compensated f32 sums a
thread, f64 from there on, the statistics finished in f64 and rounded once
to f32), y and dx rounded to the input's type. It saves JAX's residuals ``(x, mean, rstd,
scale)`` (and the row count) and no f32 copy of x.

- ``batch_stats(x)``: the f32 (mean, var) of JAX's function of that name.
- ``batch_norm_train(x, scale, bias, epsilon, mesh=None)``: ``(y, mean,
  var)``, a ``torch.autograd.Function`` (``_BatchNormTrain``); only ``y``
  carries a gradient. With a ``mesh`` (parallel/mesh.py::norm_mesh) the
  statistics are those of every rank's rows: the per-channel sums and the
  row count are all-reduced between the two launches of N1, and the
  gradient's two sums between the two launches of N2 (one all-reduce each
  way, as models/layers.py::_GlobalBatchNorm). The scale and bias gradients
  are this rank's parts, which the train step's gradient all-reduce adds.
- ``batch_norm_train_plain`` / ``batch_norm_backward_plain``: the same
  function in plain PyTorch, in f32 whatever the input type, rounded to the
  input's type at the end; ``fused_bn_fwd`` / ``fused_bn_bwd`` run them
  for CPU tensors only. For a CUDA tensor they launch N1 / N2 of
  ``csrc/fused_bn.cu`` or raise: on one rank one cooperative launch a
  half (reduction, combine and elementwise pass in one kernel), with a
  mesh two cooperative launches of the same kernel on the same grid, with
  the all-reduce between them.

Eval mode (N3; the JAX package's Norm with ``use_running_average``, whatever
``bn_impl``): ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32
on the activation as it is, rounded to its type, then, where asked, a
residual of that type added (in f32, rounded again) and a ReLU: the end of
a conv_norm_relu, or of a bottleneck unit with its shortcut.

- ``batch_norm_eval_plain``: that function as the plain PyTorch chain the
  port has always run, op for op (the per-channel factor, then one op a
  step); ``Norm`` runs it on CPU tensors, bit for bit what it was.
- ``fused_bn_eval``: N3 of ``csrc/fused_bn.cu`` through the operator
  ``torch.ops.iv2019.bn_eval`` (``csrc/torch_ops.cpp``, loaded by
  ``fused_block.ops_library``), one launch and one pass over x, for every
  eval-mode batch norm of a CUDA tensor; under ``torch.export`` its folded
  form ``bn_eval.folded``, so that an exported program holds the norm as
  one node on constants and computes nothing from the weights per
  request.

Counters: ``fused_bn_fwd.launches`` and ``fused_bn_bwd.launches`` add one
for each run of N1 and N2 on the card, of one launch or of two (one each a
BatchNorm layer a microbatch); ``fused_bn_eval.launches`` one for each N3
launch (not under export); ``batch_norm_train.layout_copies`` counts the
inputs (x forward, dy backward) that were not channels_last and were copied
to it, on either device, ``fused_bn_eval.layout_copies`` N3's x.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from iv2019_tpu_torch.ops import _build
from iv2019_tpu_torch.parallel import mesh as pmesh

__all__ = ["BnPlan", "batch_norm_backward_plain", "batch_norm_eval_plain", "batch_norm_train",
           "batch_norm_train_plain", "batch_stats", "bn_plan", "bn_vec", "fused_bn_bwd",
           "fused_bn_eval", "fused_bn_fwd", "launch_plan"]

_DIMS = (0, 2, 3)
_THREADS = 256
# channel vectors a block covers at most: 32 x 16 bytes, 512 contiguous bytes of a row
# (the kernels' per-block arrays hold a tile of at most 256 channels: 32 x 8)
_TC_MAX = 32
# rows a thread sums at least before a shape is split further
_MIN_ROWS_PER_THREAD = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def batch_stats(x: torch.Tensor):
    """flax-identical batch statistics of NCHW ``x`` over (N, H, W), f32:
    ``mean = E[x]``, ``var = max(0, E[x^2] - E[x]^2)``."""
    xf = x.float()
    mean = xf.mean(_DIMS)
    mean2 = (xf * xf).mean(_DIMS)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


# -- the plain versions, stage by stage -----------------------------------------------------

def _stats_plain(x):
    """(sum x, sum x^2, M): (2C + 1,) f32."""
    xf = x.float()
    count = xf.new_full((1,), x.numel() // x.shape[1])
    return torch.cat([xf.sum(_DIMS), (xf * xf).sum(_DIMS), count])


def _apply_plain(x, sums, scale, bias, epsilon):
    c = x.shape[1]
    count = sums[2 * c]
    mean = sums[:c] / count
    var = torch.clamp_min(sums[c:2 * c] / count - mean * mean, 0.0)
    rstd = torch.rsqrt(var + epsilon)
    mul = rstd * scale
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype), mean, var, rstd


def _bwd_sums_plain(x, dy, mean, rstd):
    """(sum dy, sum dy * xhat): (2C,) f32."""
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    dyf = dy.float()
    return torch.cat([dyf.sum(_DIMS), (dyf * xhat).sum(_DIMS)])


def _dx_plain(x, dy, mean, rstd, scale, sums, count):
    c = x.shape[1]
    xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    b = sums[:c] / count
    d = sums[c:] / count
    dx = (scale * rstd)[:, None, None] * (dy.float() - b[:, None, None]
                                          - xhat * d[:, None, None])
    return dx.to(x.dtype)


def batch_norm_train_plain(x, scale, bias, epsilon: float):
    """N1's function in plain PyTorch on one rank: (y, mean, var, rstd,
    count), f32 statistics, ``y`` in x's type; ``count`` a (1,) tensor."""
    sums = _stats_plain(x)
    y, mean, var, rstd = _apply_plain(x, sums, scale, bias, epsilon)
    return y, mean, var, rstd, sums[2 * x.shape[1]:]


def batch_norm_backward_plain(x, dy, mean, rstd, scale, count):
    """N2's function in plain PyTorch on one rank: (dx, dscale, dbias)."""
    c = x.shape[1]
    sums = _bwd_sums_plain(x, dy, mean, rstd)
    return _dx_plain(x, dy, mean, rstd, scale, sums, count), sums[c:], sums[:c]


def batch_norm_eval_plain(x, mean, var, scale, bias, epsilon: float, residual=None,
                          relu: bool = False):
    """N3's function in plain PyTorch: ``relu(residual + y)`` of the
    eval-mode norm ``y`` of NCHW ``x`` on the running statistics, y rounded
    to x's type before the add (each optional part where given)."""
    mul = torch.rsqrt(var + epsilon) * scale
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    y = y.to(x.dtype)
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


# -- the kernels ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BnPlan:
    """How N1 and N2 cut an (M, C) map: ``vec`` channels a thread loads at
    once, ``tc`` channel vectors and ``256 // tc`` rows a block covers at a
    time, ``tiles`` blocks across C, ``splits`` contiguous ranges of
    ``rows`` rows each down M (the last may be shorter). ``capacity``: the
    blocks the card holds at once (the grid, ``tiles * splits``, does not
    exceed it); ``path``: "one" (one cooperative launch) or "split" (a
    reduction launch, then an elementwise launch on the same grid, with
    the mesh's all-reduce between them); the f32 workspace holds
    ``workspace`` floats, the partials from ``partials_at`` (``_layout``)."""

    vec: int
    tc: int
    tiles: int
    splits: int
    rows: int
    capacity: int
    path: str
    partials_at: int
    workspace: int


def bn_vec(c: int, itemsize: int, align: int) -> int:
    """The widest load of at most 16 bytes, in elements, that C and
    pointers on ``align`` bytes allow."""
    return next(v for v in (8, 4, 2, 1)
                if v * itemsize <= 16 and c % v == 0 and align % (v * itemsize) == 0)


def _layout(c: int) -> dict:
    """Float offsets of the workspace's parts before the partials (as
    csrc/fused_bn.cu reads them): the f64 sums [0, 4C + 2) (2C + 1 doubles:
    the 2C sums, then N1's row count), the f32 outputs (N1: the row count,
    mean, var, rstd; N2: dbias and dscale from ``out``); the f64 partials
    (splits x 2C) start on 16 bytes."""
    out = 4 * c + 2
    return {"sums": 0, "count": out, "mean": out + 1, "var": out + 1 + c, "rstd": out + 1 + 2 * c,
            "dbias": out, "dscale": out + c, "partials": -(-(7 * c + 3) // 4) * 4}


@functools.lru_cache(maxsize=None)
def bn_plan(m: int, c: int, itemsize: int, align: int, capacity: int,
            split: bool = False) -> BnPlan:
    """The plan of an (m, c) map of ``itemsize``-byte elements whose
    pointers all lie on ``align`` bytes, for a kernel of which the card
    holds ``capacity`` blocks at once: the widest load that C and the
    alignment allow, tiles of at most ``_TC_MAX`` vectors, and as many row
    splits as fill ``capacity`` while each thread still sums
    ``_MIN_ROWS_PER_THREAD`` rows. One launch unless ``split`` (a mesh);
    both paths take the same grid. A function of its arguments alone
    (memoised), so two launches on the same shape add in the same order.
    Refuses a C whose tiles alone the card cannot hold at once (above
    ~100k channels on an H100)."""
    if m < 1 or c < 1:
        raise ValueError(f"batch norm of an empty map ({m} rows, {c} channels)")
    vec = bn_vec(c, itemsize, align)
    cv = c // vec
    tc = min(1 << (cv - 1).bit_length(), _TC_MAX)
    tr = _THREADS // tc
    tiles = -(-cv // tc)
    if tiles > capacity:
        raise ValueError(f"batch norm of {c} channels: {tiles} tiles of channels, a grid the "
                         f"card cannot hold at once ({capacity} blocks)")
    splits = max(1, min(capacity // tiles, m // (tr * _MIN_ROWS_PER_THREAD)))
    rows = -(-m // splits)
    splits = -(-m // rows)
    at = _layout(c)["partials"]
    return BnPlan(vec, tc, tiles, splits, rows, capacity, "split" if split else "one", at,
                  at + splits * 4 * c)


def _alignment(*tensors) -> int:
    """The largest power of two (up to 16) that every data pointer is a
    multiple of."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# mode, dtype, vec, then the tensors, then m, c, tc, tiles, splits, rows, partials_at, stream
_ARGTYPES = {
    "iv_bn_capacity": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "iv_bn_fwd": [_I, _I, _I, _P, _P, _P, _F, _P, _P, _LL, _I, _I, _I, _I, _LL, _LL, _P],
    "iv_bn_bwd": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _LL,
                  _P],
}
_ONE_LAUNCH, _REDUCE, _APPLY = 0, 1, 2
_entries: dict = {}
_capacities: dict = {}


def _entry(name):
    """The C entry ``name`` of csrc/fused_bn.cu, its types set once a
    process."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("fused_bn"), name)
        fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
        _entries[name] = fn
    return fn


def _capacity(device: int, half: int, code: int, vec: int) -> int:
    """The blocks of N1's (half 0) or N2's (half 1) kernel for ``code`` and
    ``vec`` that the current card holds at once, asked once a process."""
    key = (device, half, code, vec)
    blocks = _capacities.get(key)
    if blocks is None:
        out = ctypes.c_int(0)
        err = _entry("iv_bn_capacity")(half, code, vec, ctypes.byref(out))
        if err or out.value < 1:
            raise RuntimeError(f"fused_bn: occupancy of half {half} ({code}, {vec}): CUDA error "
                               f"{err}, {out.value} blocks")
        blocks = _capacities[key] = out.value
    return blocks


def launch_plan(half: int, x, *others, split: bool = False) -> BnPlan:
    """The plan N1 (``half`` 0) or N2 (1) runs for the channels_last CUDA
    tensor ``x`` beside ``others`` (the pointers that set the load width),
    on one rank or, with ``split``, as two launches; x's card must be the
    current one."""
    align = _alignment(x, *others)
    c, itemsize = x.shape[1], x.element_size()
    capacity = _capacity(x.device.index, half, _DTYPE_CODE[x.dtype], bn_vec(c, itemsize, align))
    return bn_plan(x.numel() // c, c, itemsize, align, capacity, split)


def _stream(x) -> int:
    """The handle of the current stream of x's card (what
    ``torch.cuda.current_stream(x.device).cuda_stream`` gives, without
    building a Stream object on every call)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _check_cuda(name, x, scale, *others):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be NCHW in channels_last memory, "
                         f"got {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    for t in others:
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape or \
                not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} does not match "
                             f"x {tuple(x.shape)} {x.dtype} channels_last on {x.device}")
    if scale.device != x.device or scale.dtype != torch.float32 or tuple(scale.shape) != (c,):
        raise ValueError(f"{name}: scale must be float32 ({c},) on {x.device}")


def _raise_on(err, name, x, plan, mode):
    if err:
        raise RuntimeError(f"{name} ({x.numel() // x.shape[1]}, {x.shape[1]}) {x.dtype}: "
                           f"mode {mode} of {plan}, CUDA error {err}")


def fused_bn_fwd(x, scale, bias, epsilon: float, mesh=None, _split: bool = False):
    """N1: (y, mean, var, rstd, count) of channels_last NCHW ``x``, the
    statistics over every rank of ``mesh`` (``count``: the global row
    count, a (1,) f32 tensor). One launch on one rank; two, with the
    all-reduce between them, with a ``mesh`` (or ``_split``: a mesh's two
    launches on one rank, for the checks). Runs the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        sums = _stats_plain(x)
        if mesh is not None:
            pmesh.all_reduce(sums, mesh)
        y, mean, var, rstd = _apply_plain(x, sums, scale, bias, epsilon)
        return y, mean, var, rstd, sums[2 * x.shape[1]:]
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_fwd: unsupported device {x.device}")
    _check_cuda("fused_bn_fwd", x, scale)
    if bias.device != x.device or bias.dtype != torch.float32 or bias.shape != scale.shape:
        raise ValueError(f"fused_bn_fwd: bias must be float32 {tuple(scale.shape)} on {x.device}")
    if x.device.index != torch._C._cuda_getDevice():
        with torch.cuda.device(x.device):
            return fused_bn_fwd(x, scale, bias, epsilon, mesh, _split)
    scale, bias = scale.contiguous(), bias.contiguous()
    c = x.shape[1]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = launch_plan(0, x, y, split=_split or mesh is not None)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    _, count, mean, var, rstd, _ = ws.split_with_sizes(
        (4 * c + 2, 1, c, c, c, plan.workspace - 7 * c - 3))
    run = _entry("iv_bn_fwd")
    args = (_DTYPE_CODE[x.dtype], plan.vec, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            epsilon, y.data_ptr(), ws.data_ptr(), x.numel() // c, c, plan.tc, plan.tiles,
            plan.splits, plan.rows, plan.partials_at, _stream(x))
    if plan.path == "one":
        _raise_on(run(_ONE_LAUNCH, *args), "fused_bn_fwd", x, plan, _ONE_LAUNCH)
    else:
        _raise_on(run(_REDUCE, *args), "fused_bn_fwd", x, plan, _REDUCE)
        if mesh is not None:
            pmesh.all_reduce(ws[:4 * c + 2].view(torch.float64), mesh)
        _raise_on(run(_APPLY, *args), "fused_bn_fwd", x, plan, _APPLY)
    fused_bn_fwd.launches += 1
    return y, mean, var, rstd, count


def fused_bn_bwd(x, dy, mean, rstd, scale, count, mesh=None, _split: bool = False):
    """N2: (dx, dscale, dbias) of channels_last NCHW ``x`` and ``dy``;
    ``count`` is N1's. ``dx`` takes the sums of every rank of ``mesh``;
    ``dscale`` and ``dbias`` are this rank's. One launch on one rank; two,
    with the all-reduce of a copy of the sums between them, with a ``mesh``
    (or ``_split``, as N1's). Runs the plain version for CPU tensors."""
    c = x.shape[1]
    if x.device.type == "cpu":
        local = _bwd_sums_plain(x, dy, mean, rstd)
        sums = local if mesh is None else pmesh.all_reduce(local.clone(), mesh)
        dx = _dx_plain(x, dy, mean, rstd, scale, sums, count)
        return dx, local[c:], local[:c]
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_bwd: unsupported device {x.device}")
    _check_cuda("fused_bn_bwd", x, scale, dy)
    if x.device.index != torch._C._cuda_getDevice():
        with torch.cuda.device(x.device):
            return fused_bn_bwd(x, dy, mean, rstd, scale, count, mesh, _split)
    scale = scale.contiguous()
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    plan = launch_plan(1, x, dy, dx, split=_split or mesh is not None)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    _, dbias, dscale, _ = ws.split_with_sizes((4 * c + 2, c, c, plan.workspace - 6 * c - 2))
    run = _entry("iv_bn_bwd")
    head = (_DTYPE_CODE[x.dtype], plan.vec, x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), scale.data_ptr(), count.data_ptr())
    tail = (dx.data_ptr(), ws.data_ptr(), x.numel() // c, c, plan.tc, plan.tiles, plan.splits,
            plan.rows, plan.partials_at, _stream(x))
    if plan.path == "one":
        _raise_on(run(_ONE_LAUNCH, *head, ws.data_ptr(), *tail), "fused_bn_bwd", x, plan,
                  _ONE_LAUNCH)
    else:
        _raise_on(run(_REDUCE, *head, ws.data_ptr(), *tail), "fused_bn_bwd", x, plan, _REDUCE)
        sums = ws[:4 * c].view(torch.float64)
        if mesh is not None:
            sums = pmesh.all_reduce(sums.clone(), mesh)
        _raise_on(run(_APPLY, *head, sums.data_ptr(), *tail), "fused_bn_bwd", x, plan, _APPLY)
    fused_bn_bwd.launches += 1
    return dx, dscale, dbias


class _BnEval(torch.autograd.Function):
    """N3 where autograd wants a gradient of it (the operator has no
    derivative): the kernel's forward, and the plain chain's backward,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, epsilon, residual, relu):
        ctx.save_for_backward(x, mean, var, scale, bias, residual)
        ctx.epsilon, ctx.relu = epsilon, relu
        return torch.ops.iv2019.bn_eval(x, mean, var, scale, bias, epsilon, residual, relu)

    @staticmethod
    def backward(ctx, dy):
        needs = (*ctx.needs_input_grad[:5], ctx.needs_input_grad[6])
        inputs = [t if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = batch_norm_eval_plain(*inputs[:5], ctx.epsilon, inputs[5], ctx.relu)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        dx, dmean, dvar, dscale, dbias, dres = (
            next(grads) if t is not None and t.requires_grad else None for t in inputs)
        return dx, dmean, dvar, dscale, dbias, None, dres, None


def fused_bn_eval(x, mean, var, scale, bias, epsilon: float, residual=None,
                  relu: bool = False):
    """N3: ``batch_norm_eval_plain``'s function on a CUDA tensor in one
    launch of the operator ``iv2019::bn_eval``. Raises on another device,
    on x that is not 4-D f32 or bf16, and (the operator) on parameters that
    are not f32 of x's channels or a residual unlike x. An x that is not
    channels_last is copied to it first, counted in
    ``fused_bn_eval.layout_copies``; a residual that is not (a strided
    shortcut) too. Under autograd the backward is the plain chain's
    (``_BnEval``). Under ``torch.export`` the program gets the folded form,
    ``iv2019::bn_eval.folded``, on a table of the mean, the per-channel
    factor and the bias, which the export evaluates once."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_eval: kernel N3 runs on the card, not on {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_bn_eval: x of {x.dim()} dims in {x.dtype}; N3 takes NCHW "
                         "float32 or bfloat16")
    from iv2019_tpu_torch.ops.fused_block import ops_library

    ops_library()
    exporting = torch.compiler.is_exporting()
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
        if not exporting:
            fused_bn_eval.layout_copies += 1
    if residual is not None:
        residual = residual.contiguous(memory_format=torch.channels_last)
    if exporting:
        # computed from the weights alone: a constant of the program
        table = torch.stack([mean, torch.rsqrt(var + epsilon) * scale, bias])
        return torch.ops.iv2019.bn_eval.folded(x, table, residual, relu)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, mean, var, scale, bias, residual))
    run = _BnEval.apply if grad else torch.ops.iv2019.bn_eval
    y = run(x, mean, var, scale, bias, epsilon, residual, relu)
    fused_bn_eval.launches += 1
    return y


fused_bn_fwd.launches = 0
fused_bn_bwd.launches = 0
fused_bn_eval.launches = 0
fused_bn_eval.layout_copies = 0


# -- the autograd function --------------------------------------------------------------------

def _channels_last(t):
    """``t`` itself when channels_last, else a channels_last copy, counted
    in ``batch_norm_train.layout_copies``."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    batch_norm_train.layout_copies += 1
    return t.contiguous(memory_format=torch.channels_last)


class _BatchNormTrain(torch.autograd.Function):
    """``batch_norm_train`` (see the module docstring); N1 forward, N2
    backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, mesh):
        x = _channels_last(x)
        y, mean, var, rstd, count = fused_bn_fwd(x, scale, bias, epsilon, mesh)
        ctx.save_for_backward(x, mean, rstd, scale, count)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale, count = ctx.saved_tensors
        if dy.dtype != x.dtype:
            raise ValueError(f"batch_norm_train: gradient {dy.dtype} for {x.dtype} input")
        dx, dscale, dbias = fused_bn_bwd(x, _channels_last(dy), mean, rstd, scale, count,
                                         ctx.mesh)
        return dx, dscale, dbias, None, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     epsilon: float, mesh: Optional[pmesh.Mesh] = None):
    """Normalize NCHW ``x`` by its batch statistics (those of every rank of
    ``mesh``); returns ``(y, mean, var)`` with the biased variance, which
    moves the running statistics. The classic two-reduction backward."""
    return _BatchNormTrain.apply(x, scale, bias, epsilon, mesh)


batch_norm_train.layout_copies = 0
