"""Fixed-K row-sparse posterior representation (torch port of
muscle_tpu.ops.sparse, the parts the -align path uses).

The reference stores pair posteriors as variable-nnz CSR sparse
matrices thresholded at 0.01 (reference: src/mysparsemx.h:6-98,
MIN_SPARSE_PROB). Posterior rows hold ~5 entries on average (max ~26
on BAliBASE + rdrp), so a fixed-K per-row layout (K = 32 default) is
exact in practice while keeping every shape static:

    vals: (B, Lx, K) float32   top-K probabilities per row (desc)
    cols: (B, Lx, K) int32     matching column indices, -1 = empty slot

`sparsify` reports the true max row-nnz so callers can detect (and
log) the rare truncation case.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_K = 32


def sparsify(post: torch.Tensor, k: int = DEFAULT_K):
    """(B, Lx, Ly) thresholded posterior -> (vals, cols, max_nnz).

    post must already be exactly 0 below the 0.01 sparsity threshold,
    so slot validity is simply vals > 0. Ties keep the lower column
    first (a stable descending sort), as the JAX package's top_k does.
    """
    vals, cols = torch.sort(post, dim=-1, descending=True, stable=True)
    vals = vals[..., :k]
    cols = cols[..., :k].to(torch.int32)
    valid = vals > 0.0
    vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype,
                                                device=vals.device))
    cols = torch.where(valid, cols, torch.full((), -1, dtype=torch.int32,
                                               device=cols.device))
    max_nnz = (post > 0.0).sum(dim=-1).max()
    return vals, cols, max_nnz


def densify(vals: torch.Tensor, cols: torch.Tensor, l_out: int) -> torch.Tensor:
    """(m, L, K) fixed-K rows -> (m, L, l_out) dense f32.

    Exact: column indices are unique within a row, so every output cell
    takes at most one value. Empty slots (cols == -1) go to a spare
    column that is cut off. The plain version of kernel 8
    (ops/densify_cuda.py, which writes the consistency row panel).
    """
    m, l, _ = vals.shape
    out = torch.zeros((m, l, l_out + 1), dtype=torch.float32,
                      device=vals.device)
    valid = cols >= 0
    idx = torch.where(valid, cols, l_out).long()
    out.scatter_(2, idx, torch.where(valid, vals, 0.0))
    return out[..., :l_out]


def densify_np(vals: np.ndarray, cols: np.ndarray, ly: int) -> np.ndarray:
    """(Lx, K) sparse -> (Lx, ly) dense, host-side (plain assignment —
    column indices are unique within a row)."""
    lx, k = vals.shape
    out = np.zeros((lx, ly), np.float32)
    m = cols >= 0
    ri = np.broadcast_to(np.arange(lx)[:, None], cols.shape)
    out[ri[m], cols[m]] = vals[m]
    return out


def sparsify_np(post: np.ndarray, k: int = DEFAULT_K):
    """Host-side reference sparsify (tests / tiny inputs)."""
    lx, ly = post.shape
    vals = np.zeros((lx, k), np.float32)
    cols = np.full((lx, k), -1, np.int32)
    for i in range(lx):
        nz = np.nonzero(post[i] > 0)[0]
        order = np.argsort(-post[i][nz], kind="stable")
        nz = nz[order][:k]
        vals[i, :len(nz)] = post[i][nz]
        cols[i, :len(nz)] = nz
    return vals, cols
