"""layer_norm_ms.train_segformer: device milliseconds a training step in
LayerNorm: the profiled steps' ATen layer-norm kernels, forward
(``vectorized_layer_norm_kernel``, ``LayerNormForward``, the row moments)
and backward (``layer_norm_grad_input``, ``GammaBetaBackward``, the
internal gradients), summed and divided by the steps. The ``segformer_*``
models have no group norm, which shares the moment kernels. Moves
``train_img_per_s``.
"""

NAMES = ("layer_norm", "layernorm", "gammabeta", "rowwisemoments", "computeinternalgradients",
         "computegradientfusedparams")


def match(name: str) -> bool:
    low = name.lower()
    return any(key in low for key in NAMES)


def read(run):
    if run.kind != "train" or run.trace is None or "embed_dims" not in run.config:
        return None
    ms = run.trace.device_ms(match)
    return ms / run.trace.steps if ms > 0 else None
