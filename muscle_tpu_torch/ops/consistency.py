"""Probabilistic-consistency transform as one big matrix product
(torch port of the dense path of muscle_tpu.ops.consistency).

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
beyond a sequence's true length are zero. The product runs in full
float32 on every device (TF32 is switched off explicitly): posterior
values sit near the 0.01 threshold.
"""

from __future__ import annotations

import contextlib

import torch

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
