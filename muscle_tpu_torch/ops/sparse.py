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
log) the rare truncation case. On a CUDA tensor it launches the top-K
selection kernel (csrc/sparsify_topk.cu, a warp a row, the row read
once), on a CPU tensor it runs the plain version, a stable sort of each
row (`sparsify_plain`); `sparsify_schedule_model` runs the kernel's own
schedule on the CPU. `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import numpy as np
import torch

DEFAULT_K = 32

# the kernel's constants (csrc/sparsify_topk.cu): warps a block, the
# most keys a lane holds (S, stripes of 32 ranks), and the blocks an SM
# of its grid-stride loop
TOPK_WARPS = 8
TOPK_MAX_STRIPES = 8
TOPK_BLOCKS_PER_SM = 8

LAUNCHES = {"sparsify_topk": 0}
# the kernel's launches by (Ly, K, S)
WIDTHS: Counter = Counter()

_fn = None


def reset_launches() -> None:
    LAUNCHES["sparsify_topk"] = 0
    WIDTHS.clear()


def kernel_specs():
    from ..utils.build import cuda_spec
    return [cuda_spec("sparsify_topk")]


def sparsify(post: torch.Tensor, k: int = DEFAULT_K):
    """(B, Lx, Ly) thresholded posterior -> (vals, cols, max_nnz).

    post must already be exactly 0 below the 0.01 sparsity threshold,
    so slot validity is simply vals > 0. The entries > 0 of each row go
    in order of value descending, then column ascending (the JAX
    package's lax.top_k), empty slots 0.0 / -1; max_nnz (a 0-d device
    tensor) counts a row's entries > 0 past K too. A CUDA tensor
    launches the top-K kernel (`sparsify_topk`), a CPU tensor runs
    `sparsify_plain`.
    """
    if post.device.type == "cpu":
        return sparsify_plain(post, k)
    return sparsify_topk(post, k)


def sparsify_plain(post: torch.Tensor, k: int = DEFAULT_K):
    """The plain version: a stable descending sort of each whole row."""
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


def topk_stripes(k: int) -> int:
    """S, the keys a lane of the kernel's list holds: the least power of
    two with 32 * S >= k, at most TOPK_MAX_STRIPES (more passes beyond)."""
    s = 1
    while 32 * s < k and s < TOPK_MAX_STRIPES:
        s *= 2
    return s


def topk_vector_loads(post: torch.Tensor) -> bool:
    """Whether the kernel reads `post`'s rows in 16-byte loads: unit
    column stride, Ly a multiple of 4, every row 16-byte aligned."""
    sb, sx, sy = post.stride()
    return (sy == 1 and post.shape[2] % 4 == 0 and sb % 4 == 0
            and sx % 4 == 0 and post.data_ptr() % 16 == 0)


def sparsify_schedule_model(post, k: int = DEFAULT_K,
                            stripes: int | None = None,
                            vec: bool | None = None):
    """The kernel's schedule on the CPU (numpy), row by row: passes of a
    list of 32 * S keys ((S, 32): rank s * 32 + lane), the row in steps
    of 128 columns, 4 a lane (vec; else 32, one a lane), each of a
    step's 4 columns offered across the lanes in lane order when its key
    lies between the list's last key and the pass's bound (the last key
    of the pass before); an insert counts the keys above (the ballots),
    shifts the ranks past it down one (lane l takes lane l - 1's key,
    lane 0 lane 31's of the stripe before) and takes the rank. Returns
    (vals, cols, max_nnz) as numpy arrays (max_nnz an int)."""
    p = post.detach().cpu().numpy() if torch.is_tensor(post) else post
    p = np.ascontiguousarray(p, np.float32)
    b, lx, ly = p.shape
    s_n = stripes or topk_stripes(k)
    vec = ly % 4 == 0 if vec is None else vec
    step, per = (128, 4) if vec else (32, 1)
    n = 32 * s_n
    lanes = np.arange(32)
    rank = np.arange(s_n)[:, None] * 32 + lanes[None, :]
    bits = p.view(np.uint32).astype(np.uint64) << np.uint64(32)
    vals = np.zeros((b, lx, k), np.float32)
    cols = np.full((b, lx, k), -1, np.int32)
    max_nnz = 0
    for bi in range(b):
        for xi in range(lx):
            row, rbits = p[bi, xi], bits[bi, xi]
            bound = np.uint64(2 ** 64 - 1)
            for slot0 in range(0, k, n):
                keys = np.zeros((s_n, 32), np.uint64)
                kmin, nnz = np.uint64(0), 0
                for c0 in range(0, ly, step):
                    for j in range(per):
                        col = c0 + per * lanes + j
                        inr = col < ly
                        at = np.minimum(col, ly - 1)
                        v = np.where(inr, row[at], np.float32(0))
                        key = np.where(inr, rbits[at], np.uint64(0)) | (
                            np.uint64(0xFFFFFFFF) - col.astype(np.uint64))
                        nz = v > 0
                        nnz += int(nz.sum())
                        for src in np.flatnonzero(nz & (key > kmin)
                                                  & (key < bound)):
                            c = key[src]
                            if c <= kmin:
                                continue
                            pos = int((keys > c).sum())
                            up = np.roll(keys, 1, axis=1)
                            carry = np.zeros(s_n, np.uint64)
                            carry[1:] = keys[:-1, 31]
                            shifted = np.where(lanes[None, :] > 0, up,
                                               carry[:, None])
                            keys = np.where(rank == pos, c, np.where(
                                rank > pos, shifted, keys))
                            kmin = keys[-1, 31]
                if slot0 == 0:
                    max_nnz = max(max_nnz, nnz)
                take = keys.reshape(-1)[:min(n, k - slot0)]
                vals[bi, xi, slot0:slot0 + len(take)] = (
                    (take >> np.uint64(32)).astype(np.uint32).view(np.float32))
                cols[bi, xi, slot0:slot0 + len(take)] = (
                    np.uint64(0xFFFFFFFF) - (take & np.uint64(0xFFFFFFFF))
                ).astype(np.uint32).view(np.int32)
                if keys[-1, 31] == 0:
                    break
                bound = keys[-1, 31]
    return vals, cols, max_nnz


def sparsify_topk(post: torch.Tensor, k: int = DEFAULT_K,
                  stripes: int | None = None):
    """The top-K kernel on a CUDA posterior (B, Lx, Ly) f32, any strides
    (16-byte loads where `topk_vector_loads`), 1 <= k <= Ly as lax.top_k
    takes; `stripes` forces S (a power of two up to TOPK_MAX_STRIPES: a
    K past 32 * S takes more passes). Returns (vals (B, Lx, K) f32, cols
    int32, max_nnz 0-d int32), as sparsify."""
    global _fn
    if post.device.type != "cuda":
        raise ValueError(f"sparsify_topk: want a CUDA tensor, got "
                         f"{post.device}")
    if post.dtype != torch.float32 or post.dim() != 3:
        raise ValueError("sparsify_topk: want a (B, Lx, Ly) float32 "
                         "posterior")
    b, lx, ly = post.shape
    s_n = stripes or topk_stripes(k)
    if not 1 <= k <= ly or s_n not in (1, 2, 4, 8) or ly >= 2 ** 31:
        raise ValueError(f"sparsify_topk: k={k} must lie in [1, Ly={ly}] "
                         f"(lax.top_k's range), stripes={s_n} in 1, 2, 4, 8")
    dev = post.device
    vals = torch.empty((b, lx, k), dtype=torch.float32, device=dev)
    cols = torch.empty((b, lx, k), dtype=torch.int32, device=dev)
    max_nnz = torch.zeros((), dtype=torch.int32, device=dev)
    rows = b * lx
    if rows == 0:
        return vals, cols, max_nnz
    if _fn is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        from ..utils.build import load_kernel
        _fn = load_kernel(kernel_specs()[0],
                          [vp] + [ll] * 3 + [ci] * 7 + [vp] * 4)
    fn, err = _fn
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(-(-rows // TOPK_WARPS), sms * TOPK_BLOCKS_PER_SM)
    sb, sx, sy = post.stride()
    rc = fn(post.data_ptr(), sb, sx, sy, b, lx, ly, k, s_n,
            int(topk_vector_loads(post)), blocks, vals.data_ptr(),
            cols.data_ptr(), max_nnz.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sparsify_topk launch failed: {err(rc).decode()}")
    LAUNCHES["sparsify_topk"] += 1
    WIDTHS[(ly, k, s_n)] += 1
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
