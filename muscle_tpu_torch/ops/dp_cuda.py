"""The two DP row scans of the ML distances and the SW guide tree:
hand-written CUDA kernels.

* `nw_viterbi` (csrc/nw_viterbi.cu) replaces
  muscle_tpu.ops.nw.nw_viterbi_batch (an XLA scan in the JAX package):
  global affine NW Viterbi of a batch of pairs, returning the trace bits
  of every row, the M/D/I row at each pair's lx and the scores.
* `sw_scores` (csrc/sw_scores.cu) replaces
  muscle_tpu.ops.sw.sw_scores_batch (an XLA scan too): the local
  affine SW score of each pair.

Both run one block a pair, the threads over the row's columns (a thread
owns `geometry(width)[1]` columns when the row is wider than 1024), the
substitution table in shared memory and the row's max-plus gap scan as
the JAX package's Hillis-Steele rounds, double-buffered in shared memory
(csrc/dp_rows.cuh). Their plain versions are ops/nw.nw_viterbi_plain
and ops/sw.sw_scores_plain, which follow the JAX op order; every
operation is an IEEE add or max in the same order, so kernels and plain
versions agree bit for bit. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"nw_viterbi": 0, "sw_scores": 0}

# csrc/dp_rows.cuh: at most kMaxThreads threads a block, each owning at
# most kMaxCols columns of the row; a substitution table of at most
# kMaxAlpha x kMaxAlpha
MAX_THREADS = 1024
MAX_COLS_PER_THREAD = 20
MAX_WIDTH = MAX_THREADS * MAX_COLS_PER_THREAD
MAX_ALPHA = 32

_fns: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_specs():
    """Build specs of the two libraries, each keyed on the header they
    share."""
    from ..utils.build import cuda_spec, package_path
    dep = (package_path("csrc", "dp_rows.cuh"),)
    return [cuda_spec(k, deps=dep) for k in LAUNCHES]


def geometry(width: int) -> tuple[int, int]:
    """(threads a block, columns a thread) for a row of `width` lanes,
    as the C entries pick them: one column a thread up to 1024 lanes,
    else ceil(width / 1024) columns a thread (column c * threads + t of
    thread t)."""
    cols = max(1, -(-width // MAX_THREADS))
    threads = -(-width // cols)
    return (threads + 31) // 32 * 32, cols


def _kernel(name: str):
    if name not in _fns:
        from ..utils.build import load_kernel
        vp, ci = ctypes.c_void_p, ctypes.c_int
        argtypes = {"nw_viterbi": [vp] * 5 + [ci] * 4 + [vp] * 4,
                    "sw_scores": [vp] * 5 + [ci] * 4 + [vp] * 2}[name]
        spec = next(s for s in kernel_specs() if s.name == name)
        _fns[name] = load_kernel(spec, argtypes)
    return _fns[name]


def _launch(name: str, *args) -> None:
    fn, err = _kernel(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")
    LAUNCHES[name] += 1


def _check(xb, yb, lxb, lyb, subst, width: int) -> None:
    dev = xb.device
    for t, what in ((xb, "xb"), (yb, "yb"), (lxb, "lxb"), (lyb, "lyb")):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{what}: contiguous int32 on {dev}")
    b = xb.shape[0]
    if (xb.dim() != 2 or yb.dim() != 2 or yb.shape[0] != b
            or lxb.shape != (b,) or lyb.shape != (b,)):
        raise ValueError("codes (B, BX), (B, BY) and lengths (B,)")
    if (subst.dtype != torch.float32 or subst.dim() != 2
            or subst.shape[0] != subst.shape[1]
            or not 1 <= subst.shape[0] <= MAX_ALPHA
            or not subst.is_contiguous() or subst.device != dev):
        raise ValueError(f"subst: contiguous square f32 of at most "
                         f"{MAX_ALPHA} letters on {dev}")
    if width > MAX_WIDTH:
        raise ValueError(f"a row of {width} lanes: the kernels take at most "
                         f"{MAX_WIDTH}")


def nw_viterbi(xb, yb, lxb, lyb, subst):
    """Global NW of a batch: codes (B, BX), (B, BY) int32, lengths (B,)
    int32, subst (K1, K1) f32 -> (bits (B, BX, BY+1) uint8, final
    (B, 3, BY+1) f32, scores (B,) f32), as ops/nw.nw_viterbi_plain."""
    if xb.device.type == "cpu":
        from .nw import nw_viterbi_plain
        return nw_viterbi_plain(xb, yb, lxb, lyb, subst)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    b, bx = xb.shape
    by = yb.shape[1]
    _check(xb, yb, lxb, lyb, subst, by + 1)
    dev = xb.device
    bits = torch.empty((b, bx, by + 1), dtype=torch.uint8, device=dev)
    final = torch.zeros((b, 3, by + 1), dtype=torch.float32, device=dev)
    scores = torch.zeros(b, dtype=torch.float32, device=dev)
    if b and bx:
        _launch("nw_viterbi", xb.data_ptr(), yb.data_ptr(), lxb.data_ptr(),
                lyb.data_ptr(), subst.data_ptr(), subst.shape[0], b, bx, by,
                bits.data_ptr(), final.data_ptr(), scores.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    return bits, final, scores


def sw_scores(xb, yb, lxb, lyb, subst):
    """SW scores of a batch: codes (B, BX), (B, BY) int32, lengths (B,)
    int32, subst (K1, K1) f32 -> (B,) f32, as ops/sw.sw_scores_plain."""
    if xb.device.type == "cpu":
        from .sw import sw_scores_plain
        return sw_scores_plain(xb, yb, lxb, lyb, subst)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    b, bx = xb.shape
    by = yb.shape[1]
    _check(xb, yb, lxb, lyb, subst, by)
    dev = xb.device
    scores = torch.zeros(b, dtype=torch.float32, device=dev)
    if b and bx and by:
        _launch("sw_scores", xb.data_ptr(), yb.data_ptr(), lxb.data_ptr(),
                lyb.data_ptr(), subst.data_ptr(), subst.shape[0], b, bx, by,
                scores.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return scores
