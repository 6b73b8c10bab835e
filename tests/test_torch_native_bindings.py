"""The native host library's bindings (muscle_tpu_torch/native) look the
build function up on utils.build when they load the library, not when
the module is imported: a stand-in put in its place for a while (as
tests/test_torch_sparse_topk.py does around build_all, which imports the
bindings) must leave the process able to load the library once the real
function is back, and a failure the stand-in caused must not stay.

Both run in a fresh process, so the import under the stand-in is the
first import of the bindings there, as it is in a pytest worker that
meets that test first.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa")

CHILD = r"""
import json, sys
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(1)
from muscle_tpu_torch.utils import build
real, real_nvcc = build.ensure_built, build.nvcc
build.nvcc = lambda: "nvcc"
build.ensure_built = lambda specs: None
build.build_all()                 # the first import of the bindings
build.nvcc = real_nvcc


def refuse(specs):
    raise RuntimeError("a stand-in that fails")


build.ensure_built = refuse
from muscle_tpu_torch import native
under_stand_in = native.get_lib() is None
build.ensure_built = real
from muscle_tpu_torch import MultiSequence, align
msa = align(MultiSequence.from_fasta(GOLDEN, strip_gaps=True), device="cpu")
print(json.dumps({"under_stand_in": under_stand_in,
                  "loaded": native.loaded(),
                  "rows": {s.label: s.text() for s in msa}}))
"""


def test_bindings_load_after_a_stand_in_build():
    env = dict(os.environ)
    env.pop("MUSCLE_TPU_NO_NATIVE", None)
    code = f"ROOT = {ROOT!r}\nGOLDEN = {GOLDEN!r}\n" + CHILD
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert got["under_stand_in"]
    assert got["loaded"] == (shutil.which("g++") is not None)
    from muscle_tpu_torch import MultiSequence
    gold = MultiSequence.from_fasta(GOLDEN)
    assert got["rows"] == {s.label: s.text() for s in gold}
