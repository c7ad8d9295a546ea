"""The port's host library (``native.py``, ``csrc/ctdnative.cpp``) against
the JAX package's native extension, and against its own plain versions.

Tolerances: none.  Labels, counts, boxes, short sides and scores are equal
bit for bit (the library keeps the extension's algorithms and float order,
and is built without fused multiply-adds; the plain versions repeat that
order in NumPy and Python floats).

Also: importing the port builds nothing; a missing compiler or a failed
build raises, with the compiler's message, and ``boxes_from_stats`` does not
fall back to NumPy then.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from comic_text_detector_tpu_torch import native
from comic_text_detector_tpu_torch.ops import cuda_build
from comic_text_detector_tpu_torch.ops import db_decode as tdb
from tests.torch_native_oracle import jax_ext  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masks():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:37, :53]
    out = {
        "noise30": rng.random((96, 128)) < 0.3,
        "noise45": rng.random((101, 77)) < 0.45,
        "noise70": rng.random((64, 96)) < 0.7,
        "zeros": np.zeros((33, 47), bool),
        "ones": np.ones((33, 47), bool),
        "row": rng.random((1, 200)) < 0.5,
        "col": rng.random((200, 1)) < 0.5,
        "one_pixel": np.ones((1, 1), bool),
        # checkerboards of odd sizes: the most provisional labels, where the
        # union-find's parent array grows
        "checker": (yy + xx) % 2 == 0,
        "checker_odd": ((yy + xx) % 2 == 0)[:35, :51],
        "dots": (yy % 2 == 0) & (xx % 2 == 0),
    }
    return {k: v.astype(np.uint8) for k, v in out.items()}


MASKS = _masks()


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_components_matches_jax(jax_ext, name, connectivity):
    mask = MASKS[name]
    labels, n = native.get_native().label_components(mask, connectivity)
    ref, n_ref = jax_ext.label_components(mask, connectivity)
    assert n == n_ref
    assert labels.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(labels, ref)
    plain, n_plain = native.label_components_plain(mask, connectivity)
    assert n_plain == n
    np.testing.assert_array_equal(plain, labels)


def _label_maps():
    from tests.test_torch_db_rep import _shrink_map

    rng = np.random.default_rng(1)
    out = []
    for name in ("noise45", "noise70", "checker", "row", "col", "one_pixel"):
        m = MASKS[name]
        out.append((m, rng.random(m.shape).astype(np.float32)))
    for h, w, seed in ((256, 256, 0), (192, 160, 3)):
        sm = _shrink_map(h, w, seed)
        out.append(((sm > 0.3).astype(np.uint8), sm))
    return out


@pytest.mark.parametrize("with_prob", [False, True])
def test_component_min_area_rects_matches_jax(jax_ext, with_prob):
    lib = native.get_native()
    for mask, prob in _label_maps():
        labels, n = lib.label_components(mask, 8)
        p = prob if with_prob else None
        for ratio in (1.5, 2.0):
            got = lib.component_min_area_rects(labels, n, p, ratio)
            ref = jax_ext.component_min_area_rects(labels, n, p, ratio)
            plain = native.component_min_area_rects_plain(labels, n, p, ratio)
            for a, b, c in zip(got, ref, plain):
                assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(c, a)
        if with_prob and n:
            assert got[2].max() > 0
    # labels past n_comp are background; a label without pixels gives zeros
    labels, n = lib.label_components(MASKS["noise45"], 8)
    for args in ((labels, n - 3, None, 1.5), (labels, n + 2, MASKS["noise45"].astype(np.float32), 1.5)):
        for a, b, c in zip(lib.component_min_area_rects(*args), jax_ext.component_min_area_rects(*args),
                           native.component_min_area_rects_plain(*args)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, a)


def test_import_builds_nothing():
    """A fresh interpreter imports every module of the port with the build
    helper stubbed out: no compiler runs and the library is not loaded."""
    probe = r"""
import importlib, pkgutil
from comic_text_detector_tpu_torch.ops import cuda_build
def refuse(*a, **k):
    raise AssertionError(f"a build was started at import: {a}")
cuda_build.start_build = refuse
import comic_text_detector_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from comic_text_detector_tpu_torch import native
assert native._NATIVE is None and native.build_seconds is None
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def _stats():
    from tests.test_torch_db_rep import _shrink_map

    return tdb.db_device_decode(torch.from_numpy(_shrink_map(128, 128, 0)), 0.3)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_NATIVE", None)
    monkeypatch.setattr(native, "build_seconds", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))  # nothing built there
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C.. compiler"):
        native.get_native()
    assert not native.available()
    stats = _stats()
    with pytest.raises(RuntimeError, match="no host C.. compiler"):  # no fallback to the NumPy route
        tdb.boxes_from_stats(stats, 128, 128, 128, 128)


def test_failed_build_raises_with_the_compilers_message(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / native.SOURCE).write_text('extern "C" int ctd_label_components(void) { return undefined_name; }\n')
    monkeypatch.setattr(native, "_NATIVE", None)
    monkeypatch.setattr(native, "build_seconds", None)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="undefined_name") as err:
        native.get_native()
    assert "failed" in str(err.value)
    assert os.listdir(tmp_path / "build") == []  # no library and no temporary file left


def test_library_builds_once_under_its_hash(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_NATIVE", None)
    monkeypatch.setattr(native, "build_seconds", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    lib = native.get_native()
    assert native.build_seconds > 0
    assert os.listdir(tmp_path) == [os.path.basename(native.library_path())]
    assert native.get_native() is lib
    monkeypatch.setattr(native, "_NATIVE", None)
    native.get_native()
    assert native.build_seconds == 0.0  # found under its hash, not built again
    assert native.available()
