"""Batched all-pairs posterior computation (device orchestration).

Torch port of the parts of muscle_tpu.pipeline.posteriors that `-align`
runs. The O(N^2) pair grid is the dominant cost of MPC (reference:
MPCFlat::CalcPosteriors, src/mpcflat.cpp:214-252). Pairs are padded to
a common length, packed into batches and pushed through one batch call:
on a CUDA device the hand-written kernels (ops/pairhmm_cuda.py), on the
CPU the plain torch scan (ops/pairhmm.py) — the same split the JAX
package makes between its Pallas kernels and its CPU scan.

Two routes, as in the JAX package:
* `small_family_store` (n * L <= SMALL_DENSE_NL): ONE batched pair
  call, dense (n*L)^2 consistency, top-K sparsify;
* `all_pairs_posteriors_sparse` (n = 2, or no consistency): length-
  bucketed batches sparsified into a fixed-K store.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import encode
from ..ops import pairhmm
from ..ops import sparse as sp


def encode_batch(seqs, alpha: str, pad_to: int | None = None):
    """Encode+pad sequences to (N, Lpad) int32 codes + lengths."""
    from ..alphabet import alphabet_size
    wild = alphabet_size(alpha)
    arrs = [encode(s.bytes_view(), alpha).astype(np.int32) for s in seqs]
    lens = np.array([len(a) for a in arrs], dtype=np.int32)
    lmax = int(pad_to if pad_to is not None else max((len(a) for a in arrs), default=1))
    out = np.full((len(arrs), lmax), wild, dtype=np.int32)
    for i, a in enumerate(arrs):
        out[i, :len(a)] = a
    return out, lens


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_backend(device: torch.device) -> str:
    """'cuda' (hand-written kernels) on a GPU, 'scan' on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "scan"


def _make_batch_fn(pack, with_mea: bool, device):
    """Batch function (xb, yb, lxb, lyb) -> (post, ea) on `device`."""
    if default_backend(device) == "cuda":
        from ..ops.pairhmm_cuda import batch_posteriors_cuda
        return lambda xb, yb, lxb, lyb: batch_posteriors_cuda(
            xb, yb, lxb, lyb, pack, with_mea=with_mea)
    args = pairhmm.score_args(pack, device)
    return lambda xb, yb, lxb, lyb: pairhmm.batch_posteriors(
        xb, yb, lxb, lyb, *args, with_mea=with_mea)


# Length-bucket ladder: pairs are grouped by round-up(max(Lx, Ly)) into
# these padded lengths so short pairs stop paying the family-max
# lattice. Kept at the JAX package's values: padding changes the
# numbers (the segmented scan's grouping), and parity comes first.
BUCKET_LADDER = (128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                 6144, 8192, 12288, 16384, 24576)


def _bucket_of(maxlen: int, cap: int) -> int:
    for b in BUCKET_LADDER:
        if b >= maxlen:
            return min(b, cap)
    return cap


def _bucketize(pairs, lens, cap: int, min_saving: float = 0.25):
    """Group pair indices by length bucket. Returns [(Lb, idx_list)] or
    None when bucketing saves < min_saving of total DP cells."""
    if len(pairs) <= 8:
        return None
    maxl = np.maximum(lens[[p[0] for p in pairs]],
                      lens[[p[1] for p in pairs]])
    buckets: dict[int, list[int]] = {}
    for k, ml in enumerate(maxl):
        buckets.setdefault(_bucket_of(int(ml), cap), []).append(k)
    if len(buckets) == 1:
        return None
    cells = sum(lb * lb * len(ix) for lb, ix in buckets.items())
    if cells > (1.0 - min_saving) * cap * cap * len(pairs):
        return None
    return sorted(buckets.items())


def _chunk_step(backend: str) -> int:
    """Granularity of every chunk size: 8 pairs on the kernel path (the
    JAX package's Pallas tile), 1 on the CPU scan."""
    return 8 if backend == "cuda" else 1


def _rung(x: int, step: int) -> int:
    """Round x UP to step * 2^i."""
    r = step
    while r < x:
        r *= 2
    return r


def _floor_rung(x: int, step: int) -> int:
    r = step
    while r * 2 <= x:
        r *= 2
    return r


def store_rows(n_pairs: int) -> int:
    """Pair-axis size of the sparse store (>= one dump row beyond
    n_pairs; 1/4-step geometric rungs)."""
    cap = 16
    while cap < n_pairs + 1:
        cap += max(16, cap // 4)
    return cap


def _clamp_chunk_by_len(b: int, lb: int, step: int = 8) -> int:
    """Cap the pair chunk so the (B, Lx, Ly) lattices stay within ~8 GB
    at bucket length lb (on the step * 2^i rung ladder)."""
    cap = max(step, int((8 << 30) // max(1, 12 * lb * lb)))
    return max(step, min(b, _floor_rung(cap, step)))


# beyond this padded length the batched kernels' (B, Lx, Ly) lattices
# stop fitting; the JAX package switches to its long-pair paths there,
# which this port does not have yet
LONG_PAIR_THRESHOLD = 8192

# Dense small-family threshold: the (n_pad*L)^2 block matrix of the
# one-call consistency (~1 GB per matrix at 16384^2 f32)
SMALL_DENSE_NL = 16384


def all_pairs_posteriors_sparse(codes: np.ndarray, lens: np.ndarray, pack,
                                pairs: list[tuple[int, int]], device,
                                batch_size: int = 32, k: int = 32):
    """Posteriors of the given (x, y) pairs (x < y) in a fixed-K store.

    Returns (vals (P+1.., L, K) device tensor, cols, ea (P,) numpy,
    max_nnz); rows beyond P are empty (the last one is the dump slot).
    max_nnz > K signals truncation of rows with more than K entries.
    """
    if codes.shape[1] > LONG_PAIR_THRESHOLD:
        raise NotImplementedError(
            f"pairs longer than {LONG_PAIR_THRESHOLD} columns need the "
            "long-pair path (ROADMAP.md, open item 12: long pairs)")
    backend = default_backend(device)
    step = _chunk_step(backend)
    n_pairs = len(pairs)
    l_full = codes.shape[1]
    b0 = _rung(min(batch_size, n_pairs), step)
    cj = torch.as_tensor(codes, device=device)
    lj = torch.as_tensor(lens, device=device)
    fn = _make_batch_fn(pack, True, device)

    store_v = torch.zeros((store_rows(n_pairs), l_full, k),
                          dtype=torch.float32, device=device)
    store_c = torch.full((store_rows(n_pairs), l_full, k), -1,
                         dtype=torch.int32, device=device)
    store_ea = torch.zeros((n_pairs,), dtype=torch.float32, device=device)
    max_nnz = 0
    buckets = _bucketize(pairs, lens, l_full) or \
        [(l_full, list(range(n_pairs)))]
    for lb, idxs in buckets:
        b = _clamp_chunk_by_len(b0, lb, step)
        for lo in range(0, len(idxs), b):
            ch = idxs[lo:lo + b]
            full = ch + [ch[0]] * (b - len(ch))
            xi = torch.as_tensor([pairs[t][0] for t in full], device=device)
            yi = torch.as_tensor([pairs[t][1] for t in full], device=device)
            post, ea = fn(cj[xi, :lb], cj[yi, :lb], lj[xi], lj[yi])
            vals, cols, nnz = sp.sparsify(post, k)
            del post
            idx = torch.as_tensor(full, device=device)
            store_v[idx, :lb] = vals
            store_c[idx, :lb] = cols
            store_ea[idx] = ea
            max_nnz = max(max_nnz, int(nnz))
    return store_v, store_c, store_ea.cpu().numpy(), max_nnz


def _cons_sparsify(post, xi, yi, n_real: int, p_real: int, n_pad: int,
                   iters: int, kk: int):
    """Dense consistency over the (n_pad, n_pad, L, L) pair tensor, then
    top-K sparsify of the (padded) pair rows; lanes >= p_real empty."""
    from ..ops import consistency as cons
    l = post.shape[1]
    t = torch.zeros((n_pad, n_pad, l, l), dtype=torch.float32,
                    device=post.device)
    t[xi, yi] = post
    t[yi, xi] = post.transpose(-1, -2)
    mask = cons.sparsity_mask(t)
    for _ in range(iters):
        t = cons.consistency_iter(t, mask, n_real)
    del mask
    out = t[xi, yi]
    del t
    vals, cols, nnz = sp.sparsify(out, kk)
    lane = torch.arange(vals.shape[0], device=vals.device)[:, None, None]
    vals = torch.where(lane < p_real, vals, torch.zeros((), device=vals.device))
    cols = torch.where(lane < p_real, cols,
                       torch.full((), -1, dtype=torch.int32, device=cols.device))
    return vals, cols, nnz


def small_family_store(codes, lens, pack, pairs, n: int, k: int, iters: int,
                       device):
    """ONE batched pair call + dense consistency + sparsify for small
    families (n * L <= SMALL_DENSE_NL).

    Returns (vals (P2, L, K) device, cols, ea (P,) np, max_nnz) in the
    sparse-store contract (rows beyond P empty; last row a zero dump
    slot).
    """
    n_pairs = len(pairs)
    b = _rung(n_pairs, _chunk_step(default_backend(device)))
    full = list(pairs) + [pairs[0]] * (b - n_pairs)
    xi = torch.as_tensor([p[0] for p in full], device=device)
    yi = torch.as_tensor([p[1] for p in full], device=device)
    fn = _make_batch_fn(pack, True, device)
    cj = torch.as_tensor(codes, device=device)
    lj = torch.as_tensor(lens, device=device)
    post, ea = fn(cj[xi], cj[yi], lj[xi], lj[yi])
    sv, sc, nnz = _cons_sparsify(post, xi, yi, n, n_pairs, _rung(n, 4),
                                 iters, k)
    if sv.shape[0] == n_pairs:
        # guarantee a trailing all-zero dump row
        sv = torch.nn.functional.pad(sv, (0, 0, 0, 0, 0, 8))
        sc = torch.nn.functional.pad(sc, (0, 0, 0, 0, 0, 8), value=-1)
    return sv, sc, ea.cpu().numpy()[:n_pairs], int(nnz)


def store_to_csr(store_v, store_c):
    """One host copy of a sparse store as a packed CSR stream:
    (flat_vals (total,) f32, flat_cols (total,) int32, nnz (rows, L)).
    Valid slots come in row-major order, so per-pair views are offset
    slices."""
    sv = store_v.cpu().numpy()
    sc = store_c.cpu().numpy()
    valid = sc >= 0
    return (np.ascontiguousarray(sv[valid], np.float32),
            np.ascontiguousarray(sc[valid], np.int32),
            valid.sum(axis=-1).astype(np.int64))


def csr_views(flat_v, flat_c, nnz_np, n_pairs: int, lx_of):
    """Per-pair (vals, cols, rowptr) CSR views into the packed stream.
    lx_of(i) gives pair i's row count."""
    l = nnz_np.shape[1]
    big_rowptr = np.zeros(n_pairs * l + 1, np.int64)
    np.cumsum(nnz_np[:n_pairs].ravel(), out=big_rowptr[1:])
    out = []
    for i in range(n_pairs):
        lx = lx_of(i)
        base = big_rowptr[i * l]
        end = big_rowptr[i * l + lx]
        out.append((flat_v[base:end], flat_c[base:end],
                    big_rowptr[i * l:i * l + lx + 1] - base))
    return out


def posts_from_store(store_v, store_c, pairs, lens):
    """Sparse store -> host PairPosteriors (CSR views into one buffer)."""
    from .progressive import PairPosteriors
    flat_v, flat_c, nnz_np = store_to_csr(store_v, store_c)
    views = csr_views(flat_v, flat_c, nnz_np, len(pairs),
                      lambda i: int(lens[pairs[i][0]]))
    posts = PairPosteriors()
    for (x, y), (v, c, r) in zip(pairs, views):
        posts.set_csr(x, y, v, c, r, int(lens[y]))
    return posts


def ea_dist_matrix(n: int, pairs: list[tuple[int, int]], ea: np.ndarray
                   ) -> np.ndarray:
    d = np.zeros((n, n), dtype=np.float32)
    for (x, y), v in zip(pairs, ea):
        d[x, y] = d[y, x] = v
    return d
