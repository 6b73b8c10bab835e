"""Row-panel densify of the Gram consistency: one hand-written CUDA kernel.

Port of muscle_tpu.ops.sparse._densify_kernel (kernel 8, the JAX
package's "pallas" densify) as the consistency uses it: the z-tile maps
(pids, flags) of ops/consistency.py name, for each (l, l) slab of the
(t*l, nb*l) row panel, a store row and its orientation (FLAG_STORE,
FLAG_TRANS, FLAG_EYE). The kernel (csrc/densify.cu) writes the panel
straight in its dtype (f32, or bf16 rounded to nearest even), applying
the flags as it writes: one block a tile of `tile_shape` store rows x
columns, built in shared memory and written out once;
`densify_panel_tiled_plain` walks the same tiles on the CPU.
`densify_panel_plain` does the same with ops/sparse.densify, a
transpose and a cast. Each panel cell takes at most one value, so the
three agree bit for bit. A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises. `LAUNCHES` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .sparse import densify

FLAG_STORE, FLAG_TRANS, FLAG_EYE = 0, 1, 2

# a block's tile, fixed in csrc/densify.cu (kLineBytes, kTileBytes) and
# mirrored here for the CPU twin: store rows x store columns, R rows of
# 128 bytes of the panel's dtype (one line of a transposed output row)
# and at most TILE_BYTES of shared memory. On an H100 80GB HBM3 at 700 W
# the n = 200 bf16 tile took 0.82 ms with 32 KB, 0.835 with 64 KB and
# 1.09 with 16 KB (tools/torch_fwd_densify_probe.py --variants)
LINE_BYTES = 128
TILE_BYTES = 32 * 1024

LAUNCHES = {"densify": 0}

_fn = None


def reset_launches() -> None:
    LAUNCHES["densify"] = 0


def kernel_specs():
    from ..utils.build import cuda_spec
    return [cuda_spec("densify")]


def tile_shape(l: int, dtype) -> tuple[int, int]:
    """(R, C): the store rows and columns of one block's tile at width l
    in `dtype` (f32: 32 x 256, bf16: 64 x 256; C is l below 256)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    r = LINE_BYTES // itemsize
    return r, min(l, TILE_BYTES // (r * itemsize))


def densify_panel_tiled_plain(vals, cols, pids, flags, dtype=torch.float32):
    """Kernel 8's walk on the CPU, item by item: each (slab, R-band,
    C-tile) of `tile_shape`, in the kernel's order, builds its tile as the
    kernel does (zeros; the band's slots with a column in the tile,
    transposed for FLAG_TRANS; zeros or the identity for FLAG_EYE and a
    pid outside the store) and writes it to its rectangle of the panel.
    Cells no item writes stay NaN. Returns the (t*L, nb*L) panel."""
    p1, l, k = vals.shape
    t, nb = pids.shape
    r, c = tile_shape(l, dtype)
    out = torch.full((t * l, nb * l), float("nan"), dtype=dtype)
    slot_row = torch.arange(r * k) // k
    for slab in range(t * nb):
        a, b = divmod(slab, nb)
        pid, flag = int(pids[a, b]), int(flags[a, b])
        for s0 in range(0, l, r):
            rn = min(r, l - s0)
            for c0 in range(0, l, c):
                cn = min(c, l - c0)
                if flag == FLAG_EYE or not 0 <= pid < p1:
                    tile = torch.zeros((rn, cn), dtype=dtype)
                    if flag == FLAG_EYE:
                        tile[(torch.arange(rn)[:, None] + s0)
                             == (torch.arange(cn)[None, :] + c0)] = 1.0
                    out[a * l + s0:a * l + s0 + rn,
                        b * l + c0:b * l + c0 + cn] = tile
                    continue
                # the tile's output rows: store rows s0.. (FLAG_STORE)
                # or store columns c0.. (FLAG_TRANS)
                trans = flag == FLAG_TRANS
                tile = torch.zeros(rn * cn, dtype=dtype)
                col = cols[pid, s0:s0 + rn].reshape(-1) - c0
                keep = (col >= 0) & (col < cn)
                i = slot_row[:rn * k]
                at = col * rn + i if trans else i * cn + col
                tile[at[keep]] = vals[pid, s0:s0 + rn].reshape(-1)[keep].to(
                    dtype)
                (o0, n0), (o1, n1) = ((c0, cn), (s0, rn)) if trans else \
                    ((s0, rn), (c0, cn))
                out[a * l + o0:a * l + o0 + n0,
                    b * l + o1:b * l + o1 + n1] = tile.view(n0, n1)
    return out


def densify_panel_plain(vals, cols, pids, flags, dtype=torch.float32):
    """(P1, L, K) store + (t, nb) maps -> (t*L, nb*L) panel in `dtype`."""
    l = vals.shape[1]
    t, nb = pids.shape
    ids = pids.reshape(-1).long()
    d = densify(vals[ids], cols[ids], l)
    fl = flags.reshape(-1)[:, None, None]
    d = torch.where(fl == FLAG_TRANS, d.transpose(1, 2), d)
    eye = torch.eye(l, dtype=torch.float32, device=d.device)
    d = torch.where(fl == FLAG_EYE, eye, d).to(dtype)
    return d.reshape(t, nb, l, l).permute(0, 2, 1, 3).reshape(t * l, nb * l)


def densify_panel(vals, cols, pids, flags, dtype=torch.float32):
    """Kernel 8 on a CUDA store; the plain version on a CPU one."""
    if vals.device.type == "cpu":
        return densify_panel_plain(vals, cols, pids, flags, dtype)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    global _fn
    dev = vals.device
    if (vals.dtype != torch.float32 or cols.dtype != torch.int32
            or vals.dim() != 3 or cols.shape != vals.shape
            or not vals.is_contiguous() or not cols.is_contiguous()
            or cols.device != dev):
        raise ValueError("vals f32 / cols int32: contiguous (P1, L, K) "
                         f"on {dev}")
    if (pids.dtype != torch.int32 or flags.dtype != torch.int32
            or pids.dim() != 2 or flags.shape != pids.shape
            or not pids.is_contiguous() or not flags.is_contiguous()
            or pids.device != dev or flags.device != dev):
        raise ValueError(f"pids / flags: contiguous (t, nb) int32 on {dev}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"panel dtype {dtype}: want float32 or bfloat16")
    p1, l, k = vals.shape
    t, nb = pids.shape
    if l % 8:
        raise ValueError(f"L={l}: want a multiple of 8 (16-byte stores)")
    out = torch.empty((t * l, nb * l), dtype=dtype, device=dev)
    if _fn is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        from ..utils.build import load_kernel
        _fn = load_kernel(kernel_specs()[0], [vp] * 4 + [ci] * 6 + [vp] * 2)
    fn, err = _fn
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(vals.data_ptr(), cols.data_ptr(), pids.data_ptr(),
            flags.data_ptr(), p1, l, k, t, nb, int(dtype == torch.bfloat16),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"densify launch failed: {err(rc).decode()}")
    LAUNCHES["densify"] += 1
    return out
