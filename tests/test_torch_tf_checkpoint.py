"""The port's TF checkpoint reader and converter (no TensorFlow needed).

iv2019_tpu_torch/utils/tf_checkpoint.py reads V1 and V2 checkpoints by
hand; utils/checkpoint.py::convert_tf_checkpoint_to_npz turns them into the
.npz files the warm start and the trained restore read. The fixtures under
tests/data/tf_ckpt/ were written by TensorFlow (make_fixtures.py there):
a V1 file, a V1 file with a kernel in two slices and a float16 variable,
and a V2 bundle in two shards; ``expected_*.npz`` hold TF's own reads and
the JAX package's conversions of them. Everything is held bit for bit.

The tests under ``pytest.importorskip("tensorflow")`` write random
checkpoints of the small stack with TF and hold the port's conversion to
the JAX package's, key for key and bit for bit, and the port's model
restored from it to JAX's logits (tests/test_torch_model.py's f32
tolerance: logits within 1e-3, decisions equal on >= 99.9% of pixels).
"""

import os
import shutil
import struct

import numpy as np
import pytest

from iv2019_tpu_torch import native
from iv2019_tpu_torch.utils import tf_checkpoint as tc
from iv2019_tpu_torch.utils.checkpoint import convert_tf_checkpoint_to_npz

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tf_ckpt")
V1 = os.path.join(DATA, "v1.ckpt")
V1_SLICED = os.path.join(DATA, "v1_sliced.ckpt")
V2_DIR = os.path.join(DATA, "v2")
V2_PREFIX = os.path.join(V2_DIR, "model.ckpt-7")
FIXTURES = {"v1": V1, "v1_sliced": V1_SLICED, "v2": V2_DIR}
LOGIT_ATOL = 1e-3
DECISIONS_MIN = 0.999


def _mask(crc):
    """TF's crc32c::Mask."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _assert_npz_equal(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        g, w = got[k], want[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k


# -- CRC-32C ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["native", "plain"])
def test_crc32c_known_vector(impl):
    fn = native.crc32c if impl == "native" else tc.crc32c_py
    assert fn(b"123456789") == 0xE3069283
    assert fn(b"") == 0
    # continuing a checksum is the checksum of the concatenation
    assert fn(b"56789", fn(b"1234")) == 0xE3069283


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1000, 4099])
def test_crc32c_native_matches_plain(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8).tobytes()
    assert native.crc32c(data) == tc.crc32c_py(data)
    assert native.crc32c(data[n // 2:], native.crc32c(data[:n // 2])) == tc.crc32c_py(data)
    assert tc.crc32c(memoryview(data)) == tc.crc32c_py(data)


def test_unmask_inverts_tf_mask():
    for c in (0, 1, 0xE3069283, 0xFFFFFFFF, 0x12345678):
        assert tc.unmask_crc(_mask(c)) == c


# -- reading the TF-written fixtures ------------------------------------------

@pytest.mark.parametrize("tag", ["v1", "v2"])
def test_every_variable_equals_tf_reader(tag):
    reader = tc.load_checkpoint(FIXTURES[tag])
    want = np.load(os.path.join(DATA, f"expected_{tag}.npz"))
    assert sorted(reader.get_variable_to_shape_map()) == sorted(want.files)
    for name in want.files:
        got = reader.get_tensor(name)
        assert (got.dtype, got.shape) == (want[name].dtype, want[name].shape), name
        assert got.tobytes() == want[name].tobytes(), name
        assert reader.get_variable_to_shape_map()[name] == list(want[name].shape)


def test_sliced_v1_is_assembled():
    """A kernel saved in two slices and a float16 variable, which TF 2.21's
    reader refuses, read as TF's restore op reads them."""
    reader = tc.load_checkpoint(V1_SLICED)
    want = np.load(os.path.join(DATA, "expected_v1_sliced.npz"))
    name = "resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/weights"
    assert len(reader._impl.slices[name]) == 2
    for k in want.files:
        assert reader.get_tensor(k).tobytes() == want[k].tobytes(), k
        assert reader.get_tensor(k).dtype == want[k].dtype


def test_dtypes_and_shapes():
    reader = tc.load_checkpoint(V2_DIR)
    for name, dtype in (("float64", "<f8"), ("int32", "<i4"), ("bool", "|b1"),
                        ("float16", "<f2"), ("bfloat16", "|V2")):
        assert reader.get_tensor(f"dtypes/{name}").dtype.str == dtype
    assert reader.get_tensor("global_step").dtype == np.int64
    shapes = tc.list_variables(V1)
    assert shapes["global_step"] == []
    assert shapes["resnet_v1_50/conv1/weights"] == [7, 7, 3, 64]
    assert list(shapes) == sorted(shapes)


def test_v2_spans_two_shards():
    reader = tc.load_checkpoint(V2_DIR)
    assert reader._impl.num_shards == 2
    assert {e.shard for e in reader._impl.entries.values()} == {0, 1}


@pytest.mark.parametrize("path", [V2_DIR, V2_PREFIX])
def test_directory_means_its_checkpoint_file(path):
    assert tc.load_checkpoint(path).path == V2_PREFIX
    assert tc.list_variables(path) == tc.list_variables(V2_PREFIX)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="without a 'checkpoint' file"):
        tc.load_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="no checkpoint at"):
        tc.load_checkpoint(str(tmp_path / "model.ckpt-1"))
    with pytest.raises(KeyError):
        tc.load_checkpoint(V1).get_tensor("no/such/variable")


# -- the converter --------------------------------------------------------------

@pytest.mark.parametrize("tag", ["v1", "v2"])
@pytest.mark.parametrize("mode", ["warm", "full"])
def test_convert_equals_jax_converter_output(tmp_path, tag, mode):
    out = str(tmp_path / "out.npz")
    n = convert_tf_checkpoint_to_npz(FIXTURES[tag], out, full=mode == "full")
    want = os.path.join(DATA, f"expected_{tag}_{mode}.npz")
    assert n == len(np.load(want).files)
    _assert_npz_equal(out, want)


def test_convert_drops_slots_and_keeps_shadows(tmp_path):
    warm, full = str(tmp_path / "w.npz"), str(tmp_path / "f.npz")
    convert_tf_checkpoint_to_npz(V2_DIR, warm)
    convert_tf_checkpoint_to_npz(V2_DIR, full, full=True)
    warm, full = np.load(warm).files, np.load(full).files
    for names in (warm, full):
        assert not [k for k in names if k.endswith("/Momentum") or k == "global_step"]
    assert not [k for k in warm if "ExponentialMovingAverage" in k]
    assert len([k for k in full if "ExponentialMovingAverage" in k]) == 8
    assert "dtypes/float64" in warm and "dtypes/float64" not in full


def test_warm_start_from_converted_v1(tmp_path):
    import torch

    from iv2019_tpu_torch.models.model import HierarchicalSegmentationModel, init_model
    from iv2019_tpu_torch.problem.taxonomy import get_taxonomy
    from iv2019_tpu_torch.utils.checkpoint import warm_start_from_npz

    npz = str(tmp_path / "imagenet.npz")
    convert_tf_checkpoint_to_npz(V1, npz)

    # the tiny stack with a real root (7x7x3 -> 64): the converted root
    # kernel and its BatchNorm land, the rest keeps its values
    model = init_model(HierarchicalSegmentationModel(
        taxonomy=get_taxonomy("cityscapes"), resnet_blocks=((1, 64, 16),), dtype=torch.float32),
        torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert warm_start_from_npz(model, npz) == 5
    want = np.load(os.path.join(DATA, "expected_v1.npz"))
    got = model.state_dict()
    root = "feature_extractor/base.conv1"
    np.testing.assert_array_equal(got[f"{root}.conv.weight"].numpy(),
                                  want["resnet_v1_50/conv1/weights"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got[f"{root}_norm.var"].numpy(),
                                  want["resnet_v1_50/conv1/BatchNorm/moving_variance"])
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {f"{root}.conv.weight"} | {f"{root}_norm.{leaf}" for leaf in
                                                 ("scale", "bias", "mean", "var")}


# -- corrupted checkpoints raise ------------------------------------------------------

def _copy_v2(tmp_path):
    target = tmp_path / "v2"
    shutil.copytree(V2_DIR, target)
    return str(target / "model.ckpt-7")


def _patch(path, offset, data):
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(data)


def test_flipped_data_byte_raises(tmp_path):
    prefix = _copy_v2(tmp_path)
    reader = tc.load_checkpoint(prefix)
    name, entry = next((n, e) for n, e in reader._impl.entries.items()
                       if e.shard == 0 and n.endswith("conv1/weights"))
    shard = reader._impl.shard_path(0)
    byte = open(shard, "rb").read()[entry.offset + 5]
    _patch(shard, entry.offset + 5, bytes([byte ^ 0x10]))
    with pytest.raises(ValueError, match="data checksum mismatch"):
        tc.load_checkpoint(prefix).get_tensor(name)
    with pytest.raises(ValueError, match="data checksum mismatch"):
        convert_tf_checkpoint_to_npz(prefix, str(tmp_path / "x.npz"), full=True)


def test_flipped_block_byte_raises(tmp_path):
    path = str(tmp_path / "v1.ckpt")
    shutil.copy(V1, path)
    _patch(path, 100, bytes([open(path, "rb").read()[100] ^ 0x01]))
    with pytest.raises(ValueError, match="block checksum mismatch"):
        tc.load_checkpoint(path)


@pytest.mark.parametrize("cut", [1, 20, 48, 400])
def test_truncated_index_raises(tmp_path, cut):
    prefix = _copy_v2(tmp_path)
    index = prefix + ".index"
    data = open(index, "rb").read()
    with open(index, "wb") as f:
        f.write(data[:-cut])
    with pytest.raises(ValueError, match="magic|past the end|checksum"):
        tc.load_checkpoint(prefix)


def test_bad_magic_raises(tmp_path):
    prefix = _copy_v2(tmp_path)
    size = os.path.getsize(prefix + ".index")
    _patch(prefix + ".index", size - 8, struct.pack("<Q", 0x0123456789ABCDEF))
    with pytest.raises(ValueError, match="bad table magic"):
        tc.load_checkpoint(prefix)


def test_compressed_block_raises(tmp_path):
    """A block of type 1 (snappy) with a valid checksum over it."""
    prefix = _copy_v2(tmp_path)
    index = prefix + ".index"
    data = open(index, "rb").read()
    footer = data[-tc.FOOTER_BYTES:]
    _, _, pos = tc._block_handle(footer, 0)
    offset, size, _ = tc._block_handle(footer, pos)  # the index block
    crc = _mask(tc.crc32c_py(data[offset:offset + size] + b"\x01"))
    _patch(index, offset + size, b"\x01" + struct.pack("<I", crc))
    with pytest.raises(ValueError, match="compression type 1"):
        tc.load_checkpoint(prefix)


def test_truncated_shard_raises(tmp_path):
    prefix = _copy_v2(tmp_path)
    reader = tc.load_checkpoint(prefix)
    shard = reader._impl.shard_path(1)
    with open(shard, "r+b") as f:
        f.truncate(8)
    name = next(n for n, e in reader._impl.entries.items() if e.shard == 1 and e.size > 8)
    with pytest.raises(ValueError, match="ends .* bytes early"):
        reader.get_tensor(name)


def test_uncovered_slices_raise():
    reader = tc.load_checkpoint(V1_SLICED)
    name = "resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/weights"
    reader._impl.slices[name] = reader._impl.slices[name][:1]
    with pytest.raises(ValueError, match="cover 2048 of 4096 elements"):
        reader.get_tensor(name)


def test_unsupported_dtype_and_wire_type_raise():
    with pytest.raises(ValueError, match="unsupported TF dtype 7"):
        tc._dtype(7)  # DT_STRING
    assert tc._dtype(101) == 1  # DT_FLOAT_REF reads as DT_FLOAT
    with pytest.raises(ValueError, match="wire type 3"):
        list(tc._fields(bytes([(1 << 3) | 3])))
    with pytest.raises(ValueError, match="truncated varint"):
        tc._varint(b"\x80\x80", 0)


# -- against TensorFlow and the JAX package --------------------------------------------

@pytest.fixture(scope="module")
def tf_small_checkpoints(tmp_path_factory):
    """V1 and two-shard V2 checkpoints of the small stack with the reference's
    trained names, EMA shadows, Momentum slots and global_step, written by
    TF; and the flax variables whose names they carry."""
    tf = pytest.importorskip("tensorflow")
    import flax

    from torch_parity import flax_path_to_tf_name, small_variables, threads

    threads()
    variables = small_variables()
    flat = flax.traverse_util.flatten_dict(
        {"params": dict(variables["params"]), "batch_stats": dict(variables["batch_stats"])})
    rng = np.random.RandomState(11)
    values = {}
    for path, v in flat.items():
        name = flax_path_to_tf_name(path)
        values[name] = np.asarray(v, np.float32)
        if path[0] == "params":
            values[f"exponential_moving_averages/{name}/ExponentialMovingAverage"] = (
                np.asarray(v, np.float32) * (1 + 0.01 * rng.randn(*v.shape)).astype(np.float32))
            values[f"{name}/Momentum"] = rng.randn(*v.shape).astype(np.float32)
    root = tmp_path_factory.mktemp("tf_small")
    paths = {}
    for fmt in ("v1", "v2"):
        (root / fmt).mkdir()
        g = tf.Graph()
        with g.as_default():
            for i, (name, value) in enumerate(sorted(values.items())):
                with tf.device(f"/cpu:{i % 2}"):
                    tf.compat.v1.get_variable(name, initializer=value)
            with tf.device("/cpu:0"):
                tf.compat.v1.get_variable("global_step", initializer=np.int64(42))
            if fmt == "v1":
                saver = tf.compat.v1.train.Saver(write_version=tf.compat.v1.train.SaverDef.V1)
            else:
                saver = tf.compat.v1.train.Saver(sharded=True)
            config = tf.compat.v1.ConfigProto(device_count={"CPU": 2})
            with tf.compat.v1.Session(config=config) as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                paths[fmt] = saver.save(sess, str(root / fmt / "model.ckpt"),
                                        write_meta_graph=False)
    return paths, variables, root


@pytest.mark.parametrize("fmt", ["v1", "v2"])
@pytest.mark.parametrize("full", [False, True])
def test_bit_equal_to_jax_converter(tf_small_checkpoints, fmt, full):
    from iv2019_tpu.utils.checkpoint import convert_tf_checkpoint_to_npz as jax_convert

    paths, _, root = tf_small_checkpoints
    got, want = str(root / f"port_{fmt}_{full}.npz"), str(root / f"jax_{fmt}_{full}.npz")
    n = convert_tf_checkpoint_to_npz(paths[fmt], got, full=full)
    assert n == jax_convert(paths[fmt], want, full=full)
    _assert_npz_equal(got, want)


def test_restored_logits_match_jax(tf_small_checkpoints):
    """The port's model restored (EMA) from its conversion of a TF-written
    trained checkpoint against JAX's model restored from JAX's."""
    import jax
    import jax.numpy as jnp
    import torch

    from iv2019_tpu.utils.checkpoint import convert_tf_checkpoint_to_npz as jax_convert
    from iv2019_tpu.utils.checkpoint import restore_trained_from_npz as jax_restore
    from iv2019_tpu_torch.utils.convert import restore_trained_from_npz
    from torch_parity import (jax_small_model, numpy_tree, small_images, to_numpy,
                              torch_small_model)

    paths, variables, root = tf_small_checkpoints
    port_npz, jax_npz = str(root / "port_trained.npz"), str(root / "jax_trained.npz")
    convert_tf_checkpoint_to_npz(paths["v2"], port_npz, full=True)
    jax_convert(paths["v2"], jax_npz, full=True)
    jp, js, jn = jax_restore(variables, jax_npz, restore_emas=True)
    pp, ps, pn = restore_trained_from_npz(
        {"params": numpy_tree(variables["params"]),
         "batch_stats": numpy_tree(variables["batch_stats"])}, port_npz, restore_emas=True)
    assert pn == jn
    images = small_images(seed=5)
    want = jax.jit(jax_small_model().apply)({"params": jp, "batch_stats": js},
                                            jnp.asarray(images))
    with torch.inference_mode():
        got = torch_small_model({"params": pp, "batch_stats": ps})(torch.from_numpy(images))
    for key in ("l1_logits", "l2_vehicle_logits", "l2_human_logits"):
        np.testing.assert_allclose(to_numpy(got[key]), np.asarray(want[key]), atol=LOGIT_ATOL,
                                   rtol=0, err_msg=key)
    assert (to_numpy(got["decisions"]) == np.asarray(want["decisions"])).mean() >= DECISIONS_MIN
