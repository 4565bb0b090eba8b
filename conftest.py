"""Builds the JAX package's native libraries once, before any test worker
starts.

``iv2019_tpu.native`` compiles each library into its own directory on first
use, cached by source hash, through one shared ``<so>.tmp``. Under
pytest-xdist every worker collecting ``tests/test_native.py`` asks for the
library at once, and a worker whose compile or load collides with
another's gives up for the rest of its life, skipping the whole file. Here
the xdist controller builds both libraries first, so the workers only load
them. It builds them in a child process, so that the pytest process itself
imports nothing of the JAX package.
"""

import subprocess
import sys


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", None):
        return
    subprocess.run([sys.executable, "-c", "from iv2019_tpu import native; "
                    "native.available(); native.decode_available()"],
                   cwd=config.rootpath, capture_output=True, check=False)
