"""muscle_tpu_torch — the MUSCLE v5 -align pipeline in PyTorch + CUDA.

Port of muscle_tpu (JAX) to PyTorch with hand-written CUDA kernels for
an NVIDIA H100 (muscle_tpu_torch/csrc/). The pair-HMM posteriors and the
consistency transform run on the GPU; trees, join bookkeeping and the
MEA tracebacks run on the host (numpy + a small C++ library). Entry
points run on the GPU unless `device="cpu"` is passed.

Top-level API:
    align(seqs, **opts)    -> aligned MultiSequence  (reference: -align)
"""

__version__ = "0.1.0"

from .sequence import Sequence, MultiSequence  # noqa: F401


def align(*args, **kwargs):
    from .pipeline.mpc import align as _align
    return _align(*args, **kwargs)
