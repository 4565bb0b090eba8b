"""The port's C++ serving runtime (serving/) on the CPU.

The loader (serving/aoti_loader.cc) builds here with ``g++`` against the
installed torch and serves, with no Python in its process, the
AOTInductor package that tools/export_model.py writes for the small f32
model (torch_parity.py) with the ``wire_u8`` signature: this file's one
AOTInductor compile. Its command line mirrors tests/test_serving.py's
checks of the PJRT loader (usage rc 2, a bad dtype suffix refused, ``:u8``
parsed, a missing package refused loudly) and refuses a frame the package
does not take and ``device=cuda`` without a card. ``serve()``'s report has
the JAX loader's keys, and its ``output0_fnv`` is that of the eager port's
u8 decisions on the loader's synthetic frame, rebuilt here in numpy; a
``StreamServer`` answers seeded frames with those decisions' bytes, one at
a time and pipelined, in order. The package, run in Python, gives the
exported program's decisions on every pixel.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from iv2019_tpu_torch import serving
from iv2019_tpu_torch.tools import export_model as em
from torch_parity import small_variables, threads, torch_small_model

HW = (64, 96)
SHAPE = (1, *HW, 3)
SHAPE_ARG = ",".join(map(str, SHAPE))
REPORT_KEYS = {"p90_ms", "iters", "outputs", "output0_bytes", "output0_fnv"}


@pytest.fixture(scope="module")
def binary():
    return serving.build()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(package path, program path, the eager model): the small f32 model
    exported with the u8 wire signature for the CPU, compiled."""
    threads()
    model = torch_small_model(small_variables(seed=7))
    paths = em.export_program(model, SHAPE, str(tmp_path_factory.mktemp("serve")), wire_u8=True)
    return paths["package"], paths["program"], model


def _eager_decisions(model, frames):
    with torch.no_grad():
        return em.ServedForward(model, None, True)(torch.from_numpy(frames))[0].numpy()


def _synthetic_u8(shape):
    """The loader's synthetic frame (aoti_loader.cc, as pjrt_loader.cc)."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    return ((i * np.uint64(2654435761)) % np.uint64(256)).astype(np.uint8).reshape(shape)


def _fnv(data: bytes) -> str:
    """The loader's checksum: h = h * 1099511628211 + byte, mod 2^64."""
    h = 0
    for b in data:
        h = (h * 1099511628211 + b) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, *SHAPE)).astype(np.uint8)


def _run(binary, *args):
    return subprocess.run([binary, *map(str, args)], capture_output=True, text=True, timeout=300)


def test_builds(binary):
    assert os.path.exists(binary) and os.access(binary, os.X_OK)


def test_usage_error(binary):
    proc = _run(binary)
    assert proc.returncode == 2
    assert "usage:" in proc.stderr


def test_bad_dtype_suffix_rejected(binary, tmp_path):
    proc = _run(binary, tmp_path / "m.pt2", SHAPE_ARG + ":i64", 1, "device=cpu")
    assert proc.returncode == 1
    assert "bad dtype suffix" in proc.stderr


def test_u8_suffix_parses(binary, tmp_path):
    # the shape parses; the failure must be the missing package
    proc = _run(binary, tmp_path / "nope.pt2", SHAPE_ARG + ":u8", 1, "device=cpu")
    assert proc.returncode == 1
    assert "cannot read" in proc.stderr


def test_missing_package_fails_loudly(binary, tmp_path):
    proc = _run(binary, tmp_path / "nope.pt2", SHAPE_ARG, 1, "device=cpu")
    assert proc.returncode == 1
    assert "cannot read" in proc.stderr and "nope.pt2" in proc.stderr


@pytest.mark.parametrize("option,message", [("noequals", "bad option"),
                                            ("colour=red", "unknown option"),
                                            ("device=tpu", "bad device")])
def test_bad_option_rejected(binary, tmp_path, option, message):
    proc = _run(binary, tmp_path / "m.pt2", SHAPE_ARG, 1, option)
    assert proc.returncode == 1
    assert message in proc.stderr


def test_bad_shape_rejected(binary, tmp_path):
    proc = _run(binary, tmp_path / "m.pt2", "1,64,x,3", 1, "device=cpu")
    assert proc.returncode == 1
    assert "bad shape" in proc.stderr


def test_cuda_refused_without_a_card(binary, served):
    """The default device is the card: refused where there is none, with
    no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for extra in ((), ("device=cuda",)):
        proc = _run(binary, served[0], SHAPE_ARG + ":u8", 1, *extra)
        assert proc.returncode == 1
        assert "no CUDA device" in proc.stderr


def test_serve_refuses_cuda_without_a_card(served):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.serve(served[0], SHAPE, iters=1, input_dtype="uint8")


@pytest.mark.parametrize("shape_arg,message", [(SHAPE_ARG, "takes uint8 frames"),
                                               ("1,64,64,3:u8", "takes frames of shape")])
def test_frame_the_package_does_not_take_refused(binary, served, shape_arg, message):
    proc = _run(binary, served[0], shape_arg, 1, "device=cpu")
    assert proc.returncode == 1
    assert message in proc.stderr


def test_serve_report_keys(served):
    report = serving.serve(served[0], SHAPE, iters=3, device="cpu", input_dtype="uint8")
    assert report["metric"] == "aoti_serve_p50_latency_ms" and report["unit"] == "ms"
    assert REPORT_KEYS <= set(report["detail"])
    detail = report["detail"]
    assert detail["iters"] == 3 and detail["outputs"] == 2
    assert detail["output0_bytes"] == int(np.prod(HW))  # u8 decisions
    assert detail["device"] == "cpu"
    # the schema-only operator library was loaded; it launches nothing here
    assert detail["op_launches"] == {"fused_bottleneck": 0, "fused_bottleneck_ct": 0}
    assert 0 < report["value"] <= detail["p90_ms"]


def test_serve_checksum_is_the_eager_decisions(served):
    package, _, model = served
    report = serving.serve(package, SHAPE, iters=1, device="cpu", input_dtype="uint8")
    want = _eager_decisions(model, _synthetic_u8(SHAPE))
    assert report["detail"]["output0_fnv"] == _fnv(want.tobytes())


def test_package_equals_the_exported_program(served):
    """The AOTInductor package against the program it was compiled from."""
    package, program_path, _ = served
    frames = torch.from_numpy(_frames(1, seed=3)[0])
    got = torch._inductor.aoti_load_package(package)(frames)
    want = torch.export.load(program_path).module()(frames)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)


def test_stream_round_trip(served):
    package, _, model = served
    frames = _frames(3, seed=1)
    with serving.StreamServer(package, SHAPE, device="cpu", input_dtype="uint8") as server:
        got = [server.infer(f) for f in frames]
    for f, g in zip(frames, got):
        assert g == _eager_decisions(model, f).tobytes()


def test_stream_infer_many_in_order(served):
    package, _, model = served
    frames = _frames(4, seed=2)
    server = serving.StreamServer(package, SHAPE, device="cpu", input_dtype="uint8")
    try:
        got = server.infer_many(frames)
    finally:
        rc = server.close()
    assert rc == 0
    assert got == [_eager_decisions(model, f).tobytes() for f in frames]
    log = open(server.stderr_path).read()
    assert "streaming done: 4 requests" in log and "aoti_serve_p50_latency_ms" in log


def test_stream_rejects_bad_dtype(served):
    with pytest.raises(ValueError, match="input_dtype"):
        serving.StreamServer(served[0], SHAPE, device="cpu", input_dtype="int64")


def test_stream_rejects_wrong_frame_shape(served):
    with serving.StreamServer(served[0], SHAPE, device="cpu", input_dtype="uint8") as server:
        with pytest.raises(ValueError, match="frame shape"):
            server.infer(np.zeros((1, 32, 32, 3), np.uint8))
