"""Code-snapshot zipping (a copy of iv2019_tpu/utils/util_zip.py; reference
utils/util_zip.py:5-40)."""

from __future__ import annotations

import os
import zipfile

__all__ = ["zipit"]


def zipit(src_dir: str, out_path: str) -> int:
    """Zip all .py files under ``src_dir`` into ``out_path``; returns count."""
    count = 0
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(src_dir):
            for fname in files:
                if fname.endswith(".py"):
                    full = os.path.join(root, fname)
                    zf.write(full, os.path.relpath(full, src_dir))
                    count += 1
    return count
