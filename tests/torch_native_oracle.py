"""The JAX package's native extension as an oracle for the port's host
library (``tests/test_torch_native.py``, ``tests/test_torch_db_rep.py``).

``jax_ext`` is the module ``comic_text_detector_tpu.native.get_native()``
loads from ``native/``.  Where it does not import, the fixture builds
``native/ctdnative.cpp`` into a temporary directory with ``native/setup.py``'s
flags and the Python and NumPy include paths and loads it from there;
nothing is written into ``native/``.  It skips only when that build fails.
"""

import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

import comic_text_detector_tpu.native as jnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP_FLAGS = ["-O3", "-std=c++17", "-fno-exceptions"]  # native/setup.py


def build_jax_extension(out_dir: str):
    """Build ``native/ctdnative.cpp`` as a CPython extension in ``out_dir``
    and import it; returns the module, or the compiler's output as a str."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return "no C++ compiler on PATH"
    out = os.path.join(out_dir, "ctdnative" + sysconfig.get_config_var("EXT_SUFFIX"))
    cmd = [cxx, *SETUP_FLAGS, "-shared", "-fPIC", "-I", sysconfig.get_paths()["include"], "-I", np.get_include(),
           os.path.join(ROOT, "native", "ctdnative.cpp"), "-o", out]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        return r.stdout + r.stderr
    loader = importlib.machinery.ExtensionFileLoader("ctdnative", out)
    spec = importlib.util.spec_from_file_location("ctdnative", out, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


@pytest.fixture(scope="session")
def jax_ext(tmp_path_factory):
    module = jnative.get_native()
    if module is not None:
        return module
    module = build_jax_extension(str(tmp_path_factory.mktemp("ctdnative")))
    if isinstance(module, str):
        pytest.skip(f"the JAX package's native extension does not build here:\n{module}")
    return module
