"""muscle_tpu_torch — MUSCLE v5's -align (ensembles included) and -super5
in PyTorch + CUDA.

Port of muscle_tpu (JAX) to PyTorch with hand-written CUDA kernels for
an NVIDIA H100 (muscle_tpu_torch/csrc/). The pair-HMM posteriors and the
consistency transform run on the GPU; trees, join bookkeeping and the
MEA tracebacks run on the host (numpy + a small C++ library). Entry
points run on the GPU unless `device="cpu"` is passed.

Top-level API:
    align(seqs, **opts)    -> aligned MultiSequence  (reference: -align)
    super5(seqs, **opts)   -> aligned MultiSequence  (reference: -super5)
    qscore(test, ref)      -> (Q, TC)                (reference: -qscore)
Ensembles and the EFA tools: pipeline/ensemble.py (run_align_command,
Ensemble) and the CLI (cli.py).
"""

__version__ = "0.1.0"

from .sequence import Sequence, MultiSequence  # noqa: F401
# bound at import (host code, numpy only): a later import of the
# submodule muscle_tpu_torch.qscore then cannot shadow the function
from .qscore import qscore  # noqa: F401


def align(*args, **kwargs):
    from .pipeline.mpc import align as _align
    return _align(*args, **kwargs)


def super5(*args, **kwargs):
    from .pipeline.super5 import super5 as _super5
    return _super5(*args, **kwargs)
