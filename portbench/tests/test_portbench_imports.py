"""What a cell's run imports holds no JAX and no JAX package: every module
of the harness, each driver, reader, reference and roofline, and the port's
modules the drivers call, imported in a fresh process."""

import subprocess
import sys

from portbench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
from portbench import harness, data, trace, controls
import portbench.run
for kind in ("drivers", "metrics", "roofline"):
    for p in sorted((harness.BENCH / kind).glob("*.py")):
        harness.load_module(kind, p.stem)
for p in sorted((harness.BENCH / "reference").glob("*.py")):
    if p.stem != "__init__":
        harness.reference(p.stem)
from cvad_tpu_torch.train.engine import Trainer
from cvad_tpu_torch.train.graphs import read_counters
from cvad_tpu_torch.data.batcher import BatchLoader
from cvad_tpu_torch.evaluation.scoring import make_score_fn
from cvad_tpu_torch.evaluation.serving import BatchingServer
print(harness.forbidden_loaded())
"""


def test_run_imports_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole():
    assert harness.forbidden_loaded(["cvad_tpu_torch.train", "jaxtyping",
                                     "flaxen"]) == []
    assert harness.forbidden_loaded(["cvad_tpu.models", "jax.numpy",
                                     "jaxlib", "flax.linen"]) == [
        "cvad_tpu", "flax", "jax", "jaxlib"]
