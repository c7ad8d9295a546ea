"""What a run imports, in a fresh interpreter: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or the JAX package's (the port's name
begins with the JAX package's, so names are compared whole), and a
reference that imports nothing of the port."""

import json
import subprocess
import sys

from ctd_bench.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, imports=imports)], capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    names = _top_level(
        "import ctd_bench.run, ctd_bench.harness, ctd_bench.tools.gap_probe\n"
        "import ctd_bench.loops.stream, ctd_bench.loops.page, ctd_bench.loops.train_db\n"
        "import comic_text_detector_tpu_torch.pipeline.batch, comic_text_detector_tpu_torch.training.db_trainer\n"
        "from ctd_bench import harness\n"
        "[harness.load_reader(m['name']) for m in harness.benchmark()['per_layer']]")
    assert "comic_text_detector_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "comic_text_detector_tpu"}


def test_reference_imports_nothing_of_the_port():
    names = _top_level("import ctd_bench.reference.pipeline, ctd_bench.reference.train, ctd_bench.compare")
    assert not names & {"jax", "jaxlib", "flax", "comic_text_detector_tpu", "comic_text_detector_tpu_torch"}
