"""The CUDA kernels against their plain versions on the card.

Imports no JAX, so it runs on the GPU machine, from the repo root:
``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``
(tests/conftest.py imports JAX). Skips where there is no card: a CUDA
kernel has no CPU mode. Tolerance as in chip_smoke.py: max
|got - want| / max(1, |want|) < 2e-2.
"""

import numpy as np
import pytest
import torch

from iv2019_tpu_torch.ops import fused_block as tb

SHAPES = [("fused_bottleneck", 512, 128, 1), ("fused_bottleneck", 1024, 256, 2),
          ("fused_bottleneck_ct", 2048, 512, 4), ("fused_bottleneck", 256, 128, 3),
          ("fused_bottleneck_ct", 256, 128, 1),
          # block4 on a small feature map: the rule picks the full-window
          # kernel, whose 8x4 halo does not fit, so it runs 16x2 tiles
          ("fused_bottleneck", 2048, 512, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper,c,m,rate", SHAPES)
@pytest.mark.parametrize("h,w", [(64, 128), (20, 36)])
def test_kernel_matches_plain_on_card(wrapper, c, m, rate, h, w):
    """Flagship units and ragged tiles (20x36 is no multiple of either tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import chip_smoke

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(0)
    u = chip_smoke.random_unit(rng, c, m, "cuda")
    x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.bfloat16, device="cuda")
    args = (x, u["w1"], u["b1"], u["w2"], u["b2"], u["w3"], u["b3"])
    fn = getattr(tb, wrapper)
    before = fn.launches
    got = fn(*args, rate=rate).float()
    want = tb.bottleneck_plain(*args, rate=rate).float()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert rel < chip_smoke.KERNEL_REL_TOL
