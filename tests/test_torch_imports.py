"""The port stands alone: importing every module of
``comic_text_detector_tpu_torch`` loads no JAX, flax, optax, PIL or cv2
and no module of the JAX package.  Runs in a fresh interpreter, since this test
process imports JAX for the parity tests.  The kernel and decode modules
are named, so that a module missing from the walk fails the test."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import comic_text_detector_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "PIL", "cv2", "comic_text_detector_tpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("LOADED", ",".join(loaded))
"""


def test_port_imports_no_jax_pil_cv2_or_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    report = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                  if line.startswith(("MODULES", "NAMES", "LOADED")))
    assert int(report["MODULES"]) >= 15
    names = set(report["NAMES"].split(","))
    for module in ("ops.scan_kernels", "ops.cc", "ops.morph", "ops.thresholding", "postproc.db_rep",
                   "ops.db_decode", "ops.geometry", "ops.nms", "ops.cc_kernels", "ops.finalize",
                   "training.losses", "training.init", "training.steps", "training.checkpoint",
                   "training.metrics", "training.seg_trainer", "training.db_trainer", "data.augment",
                   "data.maps", "data.seg_dataset", "data.db_dataset", "utils.io", "utils.log",
                   "training.yolo_loss", "training.yolo_trainer", "data.blk_dataset"):
        assert f"comic_text_detector_tpu_torch.{module}" in names, module
    assert report["LOADED"] == "", f"the port loaded {report['LOADED']}"


def test_resolve_device():
    from comic_text_detector_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")
