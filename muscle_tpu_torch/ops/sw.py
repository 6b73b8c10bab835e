"""Batched Smith-Waterman local-alignment scores (torch port of
muscle_tpu.ops.sw).

reference: src/sw.cpp (SWFast_Seqs_BLOSUM62), src/swdistmx.cpp
(SW-BLOSUM62 guide-tree distances, Open=-11 Ext=-1, NormScore =
score / mean length, UPGMA avg after similarity rescale).

The affine-gap SW is a row scan: with Z[i,j] = max(0, H[i-1,j-1] +
s[i,j], F[i,j]) (no within-row term) the row-gap state is E[i,j] =
max_{k<j}(Z[i,k] + open + (j-k)*ext), a max-plus affine scan along the
row (Hillis-Steele, `_maxplus_scan`); H = max(Z, E); the running
maximum is the score. `sw_scores_plain` is that scan in torch with the
JAX package's op order, over a batch dimension; `sw_scores_batch` runs
it on a CPU tensor and the hand-written kernel (ops/dp_cuda.sw_scores,
csrc/sw_scores.cu) on a CUDA one.

BLOSUM62 in the reference's Blosum62_sij units (model data,
src/blosum.cpp:8-31).
"""

from __future__ import annotations

import numpy as np
import torch

# reference: src/blosum.cpp:8-31 (row/col order ACDEFGHIKLMNPQRSTVWY);
# symmetric, upper-triangle-by-row values
_B62_ROWS = """
1.9646 -0.2043 -0.8767 -0.4319 -1.1050 0.0798 -0.8126 -0.6609 -0.3670 -0.7323 -0.4676 -0.7654 -0.4071 -0.4020 -0.7068 0.5579 -0.0227 -0.0947 -1.2634 -0.8820
-0.2043 4.2911 -1.7300 -1.8062 -1.1877 -1.2502 -1.4939 -0.6138 -1.5182 -0.6387 -0.7099 -1.3299 -1.3976 -1.4509 -1.6946 -0.4375 -0.4333 -0.4038 -1.1521 -1.2036
-0.8767 -1.7300 2.8871 0.7552 -1.7419 -0.6568 -0.5595 -1.5606 -0.3509 -1.8028 -1.5293 0.6358 -0.7401 -0.1567 -0.8029 -0.1305 -0.5254 -1.5713 -2.1072 -1.5325
-0.4319 -1.8062 0.7552 2.4514 -1.5962 -1.0551 -0.0588 -1.5972 0.3877 -1.4232 -0.9990 -0.1340 -0.5581 0.9273 -0.0577 -0.0735 -0.4316 -1.2211 -1.4177 -1.0102
-1.1050 -1.1877 -1.7419 -1.5962 3.0230 -1.5537 -0.6171 -0.0804 -1.5393 0.2074 0.0063 -1.4970 -1.7986 -1.5822 -1.3932 -1.1845 -1.0538 -0.4245 0.4588 1.4696
0.0798 -1.2502 -0.6568 -1.0551 -1.5537 2.7816 -1.0204 -1.8624 -0.7640 -1.8135 -1.3383 -0.2114 -1.0668 -0.8926 -1.1521 -0.1462 -0.7877 -1.5694 -1.2457 -1.5199
-0.8126 -1.4939 -0.5595 -0.0588 -0.6171 -1.0204 3.7555 -1.6158 -0.3605 -1.3934 -0.7756 0.2892 -1.0805 0.2240 -0.1249 -0.4408 -0.8429 -1.5587 -1.1711 0.8463
-0.6609 -0.6138 -1.5606 -1.5972 -0.0804 -1.8624 -1.6158 1.9993 -1.3351 0.7608 0.5634 -1.6085 -1.3783 -1.3848 -1.4951 -1.1741 -0.3588 1.2735 -1.2903 -0.6657
-0.3670 -1.5182 -0.3509 0.3877 -1.5393 -0.7640 -0.3605 -1.3351 2.2523 -1.2234 -0.6774 -0.0895 -0.5068 0.6363 1.0544 -0.1017 -0.3348 -1.1312 -1.4782 -0.9100
-0.7323 -0.6387 -1.8028 -1.4232 0.2074 -1.8135 -1.3934 0.7608 -1.2234 1.9247 0.9959 -1.6895 -1.4300 -1.0670 -1.0773 -1.2213 -0.5987 0.3942 -0.8159 -0.5310
-0.4676 -0.7099 -1.5293 -0.9990 0.0063 -1.3383 -0.7756 0.5634 -0.6774 0.9959 2.6963 -1.0754 -1.2382 -0.2105 -0.6836 -0.7404 -0.3331 0.3436 -0.7124 -0.4974
-0.7654 -1.3299 0.6358 -0.1340 -1.4970 -0.2114 0.2892 -1.6085 -0.0895 -1.6895 -1.0754 2.8266 -1.0002 0.0008 -0.2199 0.3005 -0.0230 -1.4382 -1.8480 -1.0409
-0.4071 -1.3976 -0.7401 -0.5581 -1.7986 -1.0668 -1.0805 -1.3783 -0.5068 -1.4300 -1.2382 -1.0002 3.6823 -0.6410 -1.0543 -0.4045 -0.5376 -1.1744 -1.8271 -1.4599
-0.4020 -1.4509 -0.1567 0.9273 -1.5822 -0.8926 0.2240 -1.3848 0.6363 -1.0670 -0.2105 0.0008 -0.6410 2.6426 0.4914 -0.0506 -0.3377 -1.0992 -0.9732 -0.7105
-0.7068 -1.6946 -0.8029 -0.0577 -1.3932 -1.1521 -0.1249 -1.4951 1.0544 -1.0773 -0.6836 -0.2199 -1.0543 0.4914 2.7367 -0.3824 -0.5612 -1.2513 -1.3397 -0.8469
0.5579 -0.4375 -0.1305 -0.0735 -1.1845 -0.1462 -0.4408 -1.1741 -0.1017 -1.2213 -0.7404 0.3005 -0.4045 -0.0506 -0.3824 1.9422 0.6906 -0.8231 -1.3759 -0.8429
-0.0227 -0.4333 -0.5254 -0.4316 -1.0538 -0.7877 -0.8429 -0.3588 -0.3348 -0.5987 -0.3331 -0.0230 -0.5376 -0.3377 -0.5612 0.6906 2.2727 -0.0278 -1.2145 -0.8030
-0.0947 -0.4038 -1.5713 -1.2211 -0.4245 -1.5694 -1.5587 1.2735 -1.1312 0.3942 0.3436 -1.4382 -1.1744 -1.0992 -1.2513 -0.8231 -0.0278 1.8845 -1.4171 -0.6038
-1.2634 -1.1521 -2.1072 -1.4177 0.4588 -1.2457 -1.1711 -1.2903 -1.4782 -0.8159 -0.7124 -1.8480 -1.8271 -0.9732 -1.3397 -1.3759 -1.2145 -1.4171 5.2520 1.0771
-0.8820 -1.2036 -1.5325 -1.0102 1.4696 -1.5199 0.8463 -0.6657 -0.9100 -0.5310 -0.4974 -1.0409 -1.4599 -0.7105 -0.8469 -0.8429 -0.8030 -0.6038 1.0771 3.2975
"""

BLOSUM62 = np.array([[float(v) for v in row.split()]
                     for row in _B62_ROWS.strip().splitlines()],
                    dtype=np.float32)
assert BLOSUM62.shape == (20, 20)
assert np.allclose(BLOSUM62, BLOSUM62.T)

# wildcard row/col score 0 (reference: MakeBlosum62SMx src/blosumsmx.cpp:30-52)
BLOSUM62_21 = np.zeros((21, 21), dtype=np.float32)
BLOSUM62_21[:20, :20] = BLOSUM62

DEFAULT_SW_OPEN = -11.0   # reference: src/swdistmx.cpp:106
DEFAULT_SW_EXT = -1.0


def _maxplus_scan(z, decay: float):
    """u_j = max_{k<=j} (z_k + (j-k)*decay) along the last axis via
    Hillis-Steele (compose: u_j = max(u_j, u_{j-k} + k*decay)), round by
    round as the JAX package's scan: each round reads the last one."""
    width = z.shape[-1]
    lane = torch.arange(width, device=z.device)
    neg_inf = torch.full((), float("-inf"), dtype=z.dtype, device=z.device)
    u = z
    k = 1
    while k < width:
        s = torch.roll(u, k, dims=-1) + k * decay
        u = torch.maximum(u, torch.where(lane >= k, s, neg_inf))
        k *= 2
    return u


def substitution_lattice(xb, yb, subst):
    """e (B, BX, BY): e[b, i, j] = subst[xb[b, i], yb[b, j]], codes
    clamped into the table as the JAX package's gather clamps them."""
    k1 = subst.shape[0]
    x = xb.long().clamp(0, k1 - 1)
    y = yb.long().clamp(0, k1 - 1)
    return subst[x[:, :, None], y[:, None, :]]


def sw_scores_plain(xb, yb, lxb, lyb, subst):
    """(B,) SW scores of padded code batches (B, BX), (B, BY) with their
    lengths; `subst` (K+1, K+1) f32, wildcard row/col = 0. The JAX
    package's `_sw_score_one` under vmap: rows and columns beyond lx / ly
    are masked."""
    e = substitution_lattice(xb, yb, subst)
    b, bx, by = e.shape
    open_, ext = DEFAULT_SW_OPEN, DEFAULT_SW_EXT
    dev = e.device
    col_ok = torch.arange(by, device=dev)[None, :] < lyb.long()[:, None]
    h = torch.zeros((b, by), dtype=torch.float32, device=dev)
    f = torch.full((b, by), float("-inf"), dtype=torch.float32, device=dev)
    best = torch.zeros(b, dtype=torch.float32, device=dev)
    zero_col = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    inf_col = torch.full((b, 1), float("-inf"), dtype=torch.float32,
                         device=dev)
    for r in range(bx):
        ok = col_ok & (r < lxb.long())[:, None]
        # F: column gap continues from the previous row
        f = torch.maximum(f + ext, h + open_ + ext)
        # Z: no within-row dependence
        diag = torch.cat([zero_col, h[:, :-1]], dim=1)
        z = torch.maximum(torch.maximum(diag + e[:, r], f),
                          torch.zeros((), device=dev))
        z = torch.where(ok, z, 0.0)
        # E via max-plus scan of Z + open, decay ext
        eg = _maxplus_scan(torch.cat([inf_col, (z + open_ + ext)[:, :-1]],
                                     dim=1), ext)
        h = torch.maximum(z, torch.where(ok, eg, 0.0))
        h = torch.maximum(h, torch.zeros((), device=dev))
        best = torch.maximum(best, h.max(dim=1).values)
    return best


def sw_scores_batch(xb, yb, lxb, lyb, subst):
    """(B,) SW scores: the plain version on CPU tensors, the sw_scores
    kernel on CUDA tensors (ops/dp_cuda.py)."""
    from .dp_cuda import sw_scores
    return sw_scores(xb, yb, lxb, lyb, subst)


def sw_dist_matrix(seqs, alpha: str, batch_size: int = 64,
                   device=None) -> np.ndarray:
    """Normalized SW similarity matrix: score / mean length
    (reference: src/swdistmx.cpp ThreadBody). The scores run on
    `device` (the card unless the CPU is asked for)."""
    from ..pipeline.posteriors import encode_batch, round_up
    from ..utils.device import resolve_device

    device = resolve_device(device)
    codes, lens = encode_batch(list(seqs), alpha,
                               pad_to=round_up(max(len(s) for s in seqs), 8))
    n = len(seqs)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    subst = torch.as_tensor(BLOSUM62_21, device=device)
    out = np.zeros((n, n), dtype=np.float32)
    b = min(batch_size, max(len(pairs), 1))
    for lo in range(0, len(pairs), b):
        chunk = pairs[lo:lo + b]
        xi = np.array([p[0] for p in chunk])
        yi = np.array([p[1] for p in chunk])
        scores = sw_scores_batch(
            *(torch.from_numpy(a).to(device) for a in
              (codes[xi], codes[yi], lens[xi], lens[yi])),
            subst).cpu().numpy()
        for k, (i, j) in enumerate(chunk):
            norm = scores[k] / ((lens[i] + lens[j]) / 2.0)
            out[i, j] = out[j, i] = norm
    return out
