"""Probabilistic-consistency transform as matrix products (torch port
of muscle_tpu.ops.consistency: the dense path for small families, the
Gram scheme over the sparse store beyond them).

The reference implements consistency as three sparse relax loops per
pair (reference: src/conspairflat.cpp:10-110, src/relaxflat.cpp:4-94):

    P'_XY = (2*P_XY + sum_{Z != X,Y} P_XZ @ P_ZY) / N

restricted to the sparsity pattern of the *original* posterior
(MySparseMx::UpdateFromPost, src/mysparsemx.cpp:88-113).

Arrange all pair posteriors as an (N*L, N*L) block matrix M with
identity diagonal blocks (P_XX = I). Then

    (M @ M)[X,Y] = 2*P_XY + sum_{Z != X,Y} P_XZ @ P_ZY

exactly, so one plain matrix product per iteration replaces the
reference's O(N^3) sparse loops. Padding is safe: posterior rows/cols
beyond a sequence's true length are zero. The dense product runs in
full float32 on every device (TF32 is switched off explicitly):
posterior values sit near the 0.01 threshold. The Gram scheme rounds
its panels to bf16 where the JAX package does (precision "default",
n >= 32; pipeline/mpc.py::consistency_precision_for).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .densify_cuda import FLAG_EYE, FLAG_TRANS, densify_panel
from .pairhmm import MIN_SPARSE_PROB


def build_block_matrix(post_nn: torch.Tensor) -> torch.Tensor:
    """(N, N, L, L) pair tensor -> (N*L, N*L) block matrix with I diagonal.

    post_nn[x, y] must already satisfy post_nn[y, x] = post_nn[x, y].T
    and post_nn[x, x] = 0; the identity diagonal is added here.
    """
    n, _, l, _ = post_nn.shape
    idx = torch.arange(n, device=post_nn.device)
    post_nn = post_nn.clone()
    post_nn[idx, idx] = torch.eye(l, dtype=post_nn.dtype,
                                  device=post_nn.device)
    return post_nn.permute(0, 2, 1, 3).reshape(n * l, n * l)


@contextlib.contextmanager
def _tf32_off():
    """Full f32 products (TF32 off) inside, the caller's flags restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def consistency_iter(post_nn: torch.Tensor, mask_nn: torch.Tensor,
                     seq_count: int) -> torch.Tensor:
    """One consistency iteration over the full pair tensor.

    post_nn: (N, N, L, L) f32, symmetric in the block sense, zero diag;
    mask_nn: the original >= 0.01 sparsity pattern; seq_count: N (the
    reference divides by the sequence count, src/mysparsemx.cpp:108).
    Returns the updated (N, N, L, L) tensor (masked, renormalized).
    """
    n, _, l, _ = post_nn.shape
    m = build_block_matrix(post_nn)
    with _tf32_off():
        mm = torch.matmul(m, m)
    del m
    upd = mm.reshape(n, l, n, l).permute(0, 2, 1, 3)
    upd = upd / torch.tensor(seq_count, dtype=torch.float32)
    upd = torch.where(mask_nn, upd, torch.zeros((), dtype=upd.dtype,
                                                device=upd.device))
    idx = torch.arange(n, device=upd.device)
    upd[idx, idx] = 0.0
    return upd


def sparsity_mask(post_nn: torch.Tensor) -> torch.Tensor:
    return post_nn >= MIN_SPARSE_PROB


# ---------------------------------------------------------------------------
# Gram-scheme consistency over the sparse store (families beyond the
# dense branch; muscle_tpu.ops.consistency.consistency_sparse)
# ---------------------------------------------------------------------------
#
# M is symmetric as a plain matrix (block (y, x) = block (x, y)^T, the
# diagonal is I), so M @ M = M^T M is a Gram matrix: each z-tile's row
# panel M[Z, :] is densified once (kernel 8, ops/densify_cuda.py) and
# serves every output block as both operands,
#
#     out[X, Y] += M[X, Z] @ M[Z, Y] = RZ[:, X]^T @ RZ[:, Y],
#
# and each product is read back only through the output pairs' fixed
# sparsity pattern, accumulated into the (P+1, L, K) store z-tile by
# z-tile in ascending order — the JAX package's blocking and order of
# the f32 sums. Reference semantics: src/relaxflat.cpp:4-94,
# src/mysparsemx.cpp:88-113 (rewrite through the old offsets).


def pair_index(x: int, y: int, n: int) -> int:
    """Index of pair (x, y), x < y, in the canonical
    [(x, y) for x in range(n) for y in range(x+1, n)] order."""
    return x * n - x * (x + 1) // 2 + (y - x - 1)


def _block_maps(n: int, nb: int, dump: int):
    """(nb, nb) pair-id and orientation-flag matrices; entry (a, b)
    describes how to materialize dense M[a, b]. The all-zero dump row
    backs padded and identity slots."""
    pid = np.full((nb, nb), dump, dtype=np.int32)
    flag = np.zeros((nb, nb), dtype=np.int32)
    for a in range(n):
        flag[a, a] = FLAG_EYE
        for b in range(a + 1, n):
            k = pair_index(a, b, n)
            pid[a, b] = k
            pid[b, a] = k
            flag[b, a] = FLAG_TRANS
    return pid, flag


def _rectangles(n: int, blk: int, group: int, dump: int):
    """Output rectangles of the upper block triangle: row block bi,
    first column block bj0 (`group` column blocks wide), and the
    (blk, group*blk) output pair ids (dump where no pair x < y)."""
    nblk = -(-n // blk)
    gw = group * blk
    rects = []
    for bi in range(nblk):
        for bj0 in range(bi, nblk, group):
            po = np.full((blk, gw), dump, np.int32)
            for a in range(bi * blk, min((bi + 1) * blk, n)):
                for b in range(max(bj0 * blk, a + 1),
                               min((bj0 + group) * blk, n)):
                    po[a - bi * blk, b - bj0 * blk] = pair_index(a, b, n)
            rects.append((bi, bj0, po))
    return rects


def _gram_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b with an f32 result: bf16 panels (precision "default" on
    the card) in one bf16 product returning f32, as the JAX package's
    preferred_element_type=f32; f32 panels with TF32 off."""
    if a.dtype == torch.bfloat16:
        return torch.mm(a.T, b, out_dtype=torch.float32)
    with _tf32_off():
        return torch.mm(a.T, b)


def consistency_sparse(vals: torch.Tensor, cols: torch.Tensor, n: int,
                       iters: int, *, seq_block: int = 16,
                       precision: str = "highest",
                       max_nnz: int | None = None) -> torch.Tensor:
    """Run `iters` consistency iterations over the sparse store.

    vals/cols: (>= P+1, L, K) in canonical pair order; rows beyond
    P = n(n-1)/2 are padding and the LAST row must be all-zero (the dump
    slot; it stays zero). Returns the updated vals (cols, the pattern,
    unchanged — reference semantics). `precision` "default" rounds the
    panels to bf16 (the JAX package's rule for n >= 32).
    """
    p1, l, k = vals.shape
    k_full = k
    if max_nnz is not None and max(8, -(-int(max_nnz) // 8) * 8) < k:
        # densify cost is linear in K and sparsify packs valid slots
        # first: run on the occupied prefix, pad back at the end (exact)
        k = max(8, -(-int(max_nnz) // 8) * 8)
    vals = vals[:, :, :k].contiguous()
    cols = cols[:, :, :k].contiguous()
    dump = p1 - 1
    assert n * (n - 1) // 2 <= dump
    blk = min(seq_block, max(1, n))
    nblk = -(-n // blk)
    # rectangle width in column blocks: keep the B operand near 16k
    # columns so each product is wide enough to amortize the A read
    group = min(max(1, 16384 // max(1, blk * l)), nblk)
    # the panel spans the real blocks plus the last rectangle's overhang
    nbp = (nblk + group - 1) * blk
    pid, flag = _block_maps(n, nbp, dump)
    dev = vals.device
    rects = [(bi, bj0, torch.as_tensor(po, device=dev).reshape(-1))
             for bi, bj0, po in _rectangles(n, blk, group, dump)]
    gw = group * blk
    bf16 = precision == "default"
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        out = torch.zeros_like(vals)
        for zi in range(nblk):
            zs = slice(zi * blk, (zi + 1) * blk)
            rz = densify_panel(
                vals, cols, torch.as_tensor(pid[zs], device=dev),
                torch.as_tensor(flag[zs], device=dev),
                torch.bfloat16 if bf16 else torch.float32)
            if bf16 and dev.type == "cpu":
                # the CPU has no bf16 product with an f32 result: the
                # exact upcast of the rounded panel gives the same sums
                # of exact bf16 products in an f32 product
                rz = rz.float()
            for bi, bj0, po in rects:
                a = rz[:, bi * blk * l:(bi + 1) * blk * l]
                b = rz[:, bj0 * blk * l:(bj0 + group) * blk * l]
                prod = _gram_product(a, b)
                # read the product through each output pair's pattern:
                # g[a, b, i, s] = prod[a*l + i, b*l + cols[p_ab, i, s]]
                cxy = cols[po].reshape(blk, gw, l, k)
                g = torch.gather(
                    prod.view(blk, l, gw, l).permute(0, 2, 1, 3), 3,
                    cxy.clamp(min=0).long())
                g = torch.where(cxy >= 0, g * inv_n, 0.0)
                # pattern ids are disjoint across rectangles; dump slots
                # add exact zeros, so the dump row stays zero
                out.index_add_(0, po, g.reshape(blk * gw, l, k))
        vals = out
    if k < k_full:
        vals = torch.nn.functional.pad(vals, (0, k_full - k))
    return vals
