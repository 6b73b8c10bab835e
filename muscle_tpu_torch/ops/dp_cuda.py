"""The two DP row scans of the ML distances and the SW guide tree:
hand-written CUDA kernels.

* `nw_viterbi` (csrc/nw_viterbi.cu) replaces
  muscle_tpu.ops.nw.nw_viterbi_batch (an XLA scan in the JAX package):
  global affine NW Viterbi of a batch of pairs, returning the trace bits
  of every row, the M/D/I row at each pair's lx and the scores.
* `sw_scores` (csrc/sw_scores.cu) replaces
  muscle_tpu.ops.sw.sw_scores_batch (an XLA scan too): the local
  affine SW score of each pair.

Both run a team of warps a pair (`geometry(width)`: one warp up to 128
lanes, a block of warps up to 4096, a thread-block cluster up to 65536),
a lane holding contiguous columns of the row in registers, the
substitution table in shared memory and the row's max-plus gap scan as
the JAX package's Hillis-Steele rounds, in registers and shuffles (in a
block each warp also runs the warp below's columns, so that the rounds
within a warp need no barrier), the rounds that cross warps through
shared memory (csrc/dp_rows.cuh). Their
plain versions are ops/nw.nw_viterbi_plain and ops/sw.sw_scores_plain,
which follow the JAX op order; every operation is an IEEE add or max in
the same order, so kernels and plain versions agree bit for bit on what
a reader uses: NW's bits of rows < lx and columns <= ly, its final rows'
columns <= ly and the scores; SW's scores. Each pair stops at its own
(lx, ly): NW's bit rows >= lx and its bit and final columns > ly are
unspecified on the card. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"nw_viterbi": 0, "sw_scores": 0}

# csrc/dp_rows.cuh: one warp a pair up to WARP_LANES lanes (2 or 4
# columns a lane), a block of warps of BLOCK_COLS columns a lane up to
# BLOCK_LANES, beyond a cluster of up to MAX_CLUSTER blocks of
# CLUSTER_LANES lanes at CLUSTER_COLS columns a lane; a substitution
# table of at most MAX_ALPHA x MAX_ALPHA
WARP = 32
WARP_LANES = 128
BLOCK_COLS = 4
BLOCK_LANES = 4096
CLUSTER_COLS = 8
CLUSTER_LANES = 8192
MAX_CLUSTER = 8
MAX_WIDTH = CLUSTER_LANES * MAX_CLUSTER
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


def geometry(width: int) -> tuple[int, int, int]:
    """(columns a lane, warps a block, blocks a pair) for a row of `width`
    lanes, as the C entries pick them: one warp of the least C in 2, 4
    that holds the row up to WARP_LANES; ceil(width / (32
    BLOCK_COLS)) warps of BLOCK_COLS columns up to BLOCK_LANES; beyond, a
    cluster of ceil(width / CLUSTER_LANES) blocks of 32 warps at
    CLUSTER_COLS columns a lane. Raises past MAX_WIDTH."""
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"a row of {width} lanes: the kernels take 1 to "
                         f"{MAX_WIDTH} (a cluster of {MAX_CLUSTER} blocks "
                         f"of {CLUSTER_LANES})")
    if width <= WARP_LANES:
        cols = 2
        while cols * WARP < width:
            cols *= 2
        return cols, 1, 1
    if width <= BLOCK_LANES:
        return BLOCK_COLS, -(-width // (WARP * BLOCK_COLS)), 1
    return (CLUSTER_COLS, CLUSTER_LANES // (WARP * CLUSTER_COLS),
            -(-width // CLUSTER_LANES))


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
                         f"{MAX_WIDTH} (a cluster of {MAX_CLUSTER} blocks of "
                         f"{CLUSTER_LANES})")


def nw_viterbi(xb, yb, lxb, lyb, subst):
    """Global NW of a batch: codes (B, BX), (B, BY) int32, lengths (B,)
    int32, subst (K1, K1) f32 -> (bits (B, BX, BY+1) uint8, final
    (B, 3, BY+1) f32, scores (B,) f32), as ops/nw.nw_viterbi_plain on
    each pair's bit rows < lx and columns <= ly, its final columns <= ly
    and its score; on the card the other cells are unspecified (the
    kernel stops at (lx, ly)), and a pair with lx > BX or ly > BY keeps
    zero final rows and score."""
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
    int32, subst (K1, K1) f32 -> (B,) f32, as ops/sw.sw_scores_plain (the
    kernel runs each pair's min(lx, BX) rows of min(ly, BY) columns, the
    only cells that can raise its score)."""
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
