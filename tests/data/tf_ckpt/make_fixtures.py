"""Writes the TF checkpoint fixtures of tests/test_torch_tf_checkpoint.py.

    python tests/data/tf_ckpt/make_fixtures.py

Needs TensorFlow (graph-mode ``tf.compat.v1`` savers). Writes, next to this
file:

- ``v1.ckpt``: one V1 (``SavedTensorSlices``) file, as the slim ImageNet
  ``resnet_v1_50.ckpt`` is: the ResNet-50 root conv and its BatchNorm at
  their real shapes, a logits kernel and its ``Momentum`` slot,
  ``global_step`` (int64), and float64, int32 and bool variables;
- ``v1_sliced.ckpt``: a V1 file holding the block1/unit_1 conv1 kernel at
  its real shape, partitioned into two slices, and a float16 variable (TF's
  V1 writer cannot save bfloat16), and ``expected_v1_sliced.npz``, their
  values as TF's restore op reads them;
- ``v2/model.ckpt-7.{index,data-0000k-of-00002}`` and ``v2/checkpoint``: a
  V2 bundle written by a sharded saver from two CPU devices, with the
  reference's trained-model names (``feature_extractor/...``,
  ``adaptation_module/...``, ``softmax_classifier/...``), their
  ``exponential_moving_averages/.../ExponentialMovingAverage`` shadows and
  ``Momentum`` slots, ``global_step`` and the other dtypes;
- ``expected_{v1,v2}.npz``: every variable as TF's own reader returns it
  (``tf.train.load_checkpoint``);
- ``expected_{v1,v2}_{warm,full}.npz``: the JAX package's
  ``convert_tf_checkpoint_to_npz`` with ``full=False`` / ``full=True``.

Values are multiples of 1/8 in [-1, 1) so that the files compress in git.
"""

import os
import shutil
import sys

import numpy as np
import tensorflow as tf

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))


def _values(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.randint(0, 2, shape).astype(bool)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-1000, 1000, shape).astype(dtype)
    return (rng.randint(-8, 8, shape) / 8.0).astype(dtype)


OTHER_DTYPES = [("float64", tf.float64), ("int32", tf.int32), ("bool", tf.bool),
                ("float16", tf.float16), ("bfloat16", tf.bfloat16)]

# slim ImageNet names (define_initializers.py keeps all but the exclusions)
V1_VARS = [
    ("resnet_v1_50/conv1/weights", (7, 7, 3, 64)),
    ("resnet_v1_50/conv1/BatchNorm/gamma", (64,)),
    ("resnet_v1_50/conv1/BatchNorm/beta", (64,)),
    ("resnet_v1_50/conv1/BatchNorm/moving_mean", (64,)),
    ("resnet_v1_50/conv1/BatchNorm/moving_variance", (64,)),
    ("resnet_v1_50/logits/weights", (1, 1, 8, 5)),
    ("resnet_v1_50/logits/weights/Momentum", (1, 1, 8, 5)),
]
V1_PARTITIONED = ("resnet_v1_50/block1/unit_1/bottleneck_v1/conv1/weights", (1, 1, 64, 64))

# the reference's trained-model names (tests/torch_parity.py::flax_path_to_tf_name)
V2_VARS = [
    "feature_extractor/resnet_v1_50/conv1/weights",
    "feature_extractor/resnet_v1_50/conv1/BatchNorm/gamma",
    "feature_extractor/resnet_v1_50/conv1/BatchNorm/moving_mean",
    "feature_extractor/resnet_v1_50/block1/unit_1/bottleneck_v1/conv2/weights",
    "feature_extractor/extension/decrease_fdims/weights",
    "adaptation_module/l1_features/bottleneck_v1/conv1/weights",
    "adaptation_module/l1_features/bottleneck_v1/conv1/BatchNorm/beta",
    "softmax_classifier/l1_logits/weights",
]
V2_SHAPES = [(3, 3, 3, 4), (4,), (4,), (3, 3, 2, 2), (1, 1, 8, 4), (1, 1, 4, 2), (2,),
             (1, 1, 4, 14)]


def write_v1(path, sliced_path):
    """``path``: what TF's own reader reads back; ``sliced_path``: a kernel
    partitioned into two slices and a float16 variable, which TF 2.21's
    ``CheckpointReader.get_tensor`` refuses ("Data type not supported") but
    its restore op reads. Returns the sliced file's values as that op reads
    them."""
    rng = np.random.RandomState(1)
    g = tf.Graph()
    with g.as_default():
        plain = [tf.compat.v1.get_variable(name, initializer=_values(rng, shape, np.float32))
                 for name, shape in V1_VARS]
        plain.append(tf.compat.v1.get_variable("global_step", initializer=np.int64(1234)))
        # TF's V1 writer cannot save bfloat16; float16 goes to the sliced file
        for suffix, dt in OTHER_DTYPES[:3]:
            plain.append(tf.compat.v1.get_variable(
                f"dtypes/{suffix}", initializer=tf.constant(_values(rng, (3, 2),
                                                                    dt.as_numpy_dtype), dt)))
        name, shape = V1_PARTITIONED
        full = _values(rng, shape, np.float32)

        def part(part_shape, dtype=None, partition_info=None):
            # each partition's own block of the full value
            offset = partition_info.var_offset
            return full[tuple(slice(o, o + n) for o, n in zip(offset, part_shape))]

        sliced = tf.compat.v1.get_variable(
            name, shape=shape, dtype=tf.float32, initializer=part,
            partitioner=tf.compat.v1.fixed_size_partitioner(2, axis=2))
        half = tf.compat.v1.get_variable(
            "dtypes/float16", initializer=tf.constant(_values(rng, (3, 2), np.float16)))
        v1 = tf.compat.v1.train.SaverDef.V1
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver(plain, write_version=v1).save(
                sess, path, write_meta_graph=False, write_state=False)
            saver = tf.compat.v1.train.Saver({name: sliced, "dtypes/float16": half},
                                             write_version=v1)
            saver.save(sess, sliced_path, write_meta_graph=False, write_state=False)
            sess.run(tf.compat.v1.global_variables_initializer())  # forget, then restore
            saver.restore(sess, sliced_path)
            return {name: sess.run(tf.concat(list(sliced), axis=2)),
                    "dtypes/float16": sess.run(half)}


def write_v2(directory):
    rng = np.random.RandomState(2)
    g = tf.Graph()
    with g.as_default():
        for i, (name, shape) in enumerate(zip(V2_VARS, V2_SHAPES)):
            with tf.device(f"/cpu:{i % 2}"):
                value = _values(rng, shape, np.float32)
                tf.compat.v1.get_variable(name, initializer=value)
                tf.compat.v1.get_variable(
                    f"exponential_moving_averages/{name}/ExponentialMovingAverage",
                    initializer=value + np.float32(0.5))
                tf.compat.v1.get_variable(f"{name}/Momentum", initializer=value * 0 + 0.25)
        with tf.device("/cpu:1"):
            tf.compat.v1.get_variable("global_step", initializer=np.int64(7))
            for suffix, dt in OTHER_DTYPES:
                value = _values(rng, (2, 3), dt.as_numpy_dtype if dt != tf.bfloat16
                                else np.float32)
                tf.compat.v1.get_variable(f"dtypes/{suffix}", initializer=tf.constant(value, dt))
        saver = tf.compat.v1.train.Saver(sharded=True, save_relative_paths=True)
        config = tf.compat.v1.ConfigProto(device_count={"CPU": 2})
        with tf.compat.v1.Session(config=config) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, os.path.join(directory, "model.ckpt"), global_step=7,
                       write_meta_graph=False)


def dump(path, out):
    reader = tf.train.load_checkpoint(path)
    np.savez(out, **{name: reader.get_tensor(name)
                     for name in reader.get_variable_to_shape_map()})


def main():
    from iv2019_tpu.utils.checkpoint import convert_tf_checkpoint_to_npz

    v1, v1_sliced = os.path.join(HERE, "v1.ckpt"), os.path.join(HERE, "v1_sliced.ckpt")
    v2_dir = os.path.join(HERE, "v2")
    for path in (v1, v1_sliced):
        if os.path.exists(path):
            os.remove(path)
    shutil.rmtree(v2_dir, ignore_errors=True)
    os.makedirs(v2_dir)
    np.savez(os.path.join(HERE, "expected_v1_sliced.npz"), **write_v1(v1, v1_sliced))
    write_v2(v2_dir)
    for tag, path in (("v1", v1), ("v2", v2_dir)):
        dump(path, os.path.join(HERE, f"expected_{tag}.npz"))
        for mode, full in (("warm", False), ("full", True)):
            convert_tf_checkpoint_to_npz(path, os.path.join(HERE, f"expected_{tag}_{mode}.npz"),
                                         full=full)
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            print(os.path.relpath(os.path.join(root, f), HERE),
                  os.path.getsize(os.path.join(root, f)))


if __name__ == "__main__":
    main()
