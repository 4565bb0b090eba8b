"""Time the phases of the WMMA root-conv wgrad kernel apart, on one CUDA card.

    python3 tools/probe_wgrad_phases.py

Builds ``tools/probe_wgrad_phases.cu`` (the kernel ``csrc/root_wgrad.cu``
held before its redesign, with a mask that leaves phases out) and times it
at the flagship train step's shape, x (16, 512, 1024, 3) and dy (16, 256,
512, 64) bf16, with each phase removed in turn and with only one phase
left. Device times from replays of a CUDA graph of one launch. Prints one
JSON line: ``ms`` by mask, where bit 1 removes the global loads, 2 the
stores that stage x and dy in shared memory, 4 the im2row build and 8 the
products. A phase's cost is the full kernel's time less the time without it.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASKS = {"all phases": 0, "no loads": 1, "no staging": 2, "no im2row": 4, "no products": 8,
         "loads only": 14, "loads + staging": 12, "im2row only": 11, "products only": 7,
         "nothing (barriers and loop)": 15}


def main():
    if not torch.cuda.is_available():
        print("probe_wgrad_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from iv2019_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = _build.BUILD_DIR / "libprobe_wgrad_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    os.path.join(ROOT, "tools", "probe_wgrad_phases.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    n, c, h, w, cout, k = 16, 3, 512, 1024, 64, 7
    gen = torch.Generator("cuda").manual_seed(0)
    x = (torch.rand((n, h, w, c), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    dy = torch.randn((n, h // 2, w // 2, cout), generator=gen, device="cuda").to(torch.bfloat16)
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    lib.iv_probe_wgrad_scratch.argtypes = [ctypes.c_int] * 4
    lib.iv_probe_wgrad_scratch.restype = ctypes.c_longlong
    partial = torch.empty(lib.iv_probe_wgrad_scratch(c, cout, k, blocks), device="cuda")
    dw = torch.empty((cout, c, k, k), device="cuda")
    fn = lib.iv_probe_wgrad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(mask):
        err = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(), n, h, w, c,
                 h // 2, w // 2, cout, k, blocks, mask, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"iv_probe_wgrad: {err}")

    def device_ms(mask, runs=20):
        launch(mask)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launch(mask)
        for _ in range(3):
            graph.replay()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(runs)]
        for start, end in events:
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in events]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    # twice over, in opposite orders, to see the spread
    first = {name: device_ms(mask) for name, mask in MASKS.items()}
    second = {name: device_ms(mask) for name, mask in reversed(list(MASKS.items()))}
    chunks_per_block = n * (h // 2) * (w // 2 // 64) / blocks
    print(json.dumps({"card": smi, "blocks": blocks, "chunks_per_block": chunks_per_block,
                      "ms": first, "ms_again": second}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
