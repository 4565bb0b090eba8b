"""The PyTorch port imports neither JAX nor any module of the JAX package."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import iv2019_tpu_torch
names = ["chip_smoke"]
for info in pkgutil.walk_packages(iv2019_tpu_torch.__path__, "iv2019_tpu_torch."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "iv2019_tpu_torch.predict_cli" in result["imported"]
    assert "iv2019_tpu_torch.ops.fused_block" in result["imported"]
    for name in ("iv2019_tpu_torch.ops.fused_loss", "iv2019_tpu_torch.ops.fused_update",
                 "iv2019_tpu_torch.train.fused_update", "iv2019_tpu_torch.train.step",
                 "iv2019_tpu_torch.losses.hierarchical", "iv2019_tpu_torch.ops.root_wgrad",
                 "iv2019_tpu_torch.ops.rasterize", "iv2019_tpu_torch.input.core",
                 "iv2019_tpu_torch.input.tfrecord", "iv2019_tpu_torch.input.cityscapes",
                 "iv2019_tpu_torch.input.openimages", "iv2019_tpu_torch.input.heterogeneous",
                 "iv2019_tpu_torch.input.prefetch", "iv2019_tpu_torch.utils.checkpoint",
                 "iv2019_tpu_torch.utils.tb_writer", "iv2019_tpu_torch.utils.util_zip",
                 "iv2019_tpu_torch.train.loop", "iv2019_tpu_torch.system",
                 "iv2019_tpu_torch.train_cli", "iv2019_tpu_torch.evaluate_cli",
                 "iv2019_tpu_torch.input.tfrecord_writer", "iv2019_tpu_torch.input.vistas",
                 "iv2019_tpu_torch.tools.make_tfrecords", "iv2019_tpu_torch.ops.augment",
                 "iv2019_tpu_torch.native", "iv2019_tpu_torch.tools.synthetic_scenes",
                 "iv2019_tpu_torch.models.model", "iv2019_tpu_torch.models.resnet",
                 "iv2019_tpu_torch.train.state", "iv2019_tpu_torch.train.optimizer",
                 "iv2019_tpu_torch.utils.convert", "iv2019_tpu_torch.parallel.mesh",
                 "iv2019_tpu_torch.parallel.multihost", "iv2019_tpu_torch.tools.export_model",
                 "iv2019_tpu_torch.serving", "iv2019_tpu_torch.bench",
                 "iv2019_tpu_torch.utils.tf_checkpoint", "iv2019_tpu_torch.tools.overfit_probe",
                 "iv2019_tpu_torch.tools.weak_ab", "iv2019_tpu_torch.tools.quality_ab",
                 "iv2019_tpu_torch.tools.spatial_memory_table", "iv2019_tpu_torch.ops.fused_bn",
                 "iv2019_tpu_torch.utils.spans"):
        assert name in result["imported"], name
    loaded = result["loaded"]
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "flax" or m.startswith("flax.")]
    # the port's own name shares the prefix: match the JAX package exactly
    assert not [m for m in loaded if m == "iv2019_tpu" or m.startswith("iv2019_tpu.")]
    # nor the repository's JAX-side tools (tools/*.py): the port has its own
    assert not [m for m in loaded if m == "tools" or m.startswith("tools.")]
