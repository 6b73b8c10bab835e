"""Row-panel densify of the Gram consistency: one hand-written CUDA kernel.

Port of muscle_tpu.ops.sparse._densify_kernel (kernel 8, the JAX
package's "pallas" densify) as the consistency uses it: the z-tile maps
(pids, flags) of ops/consistency.py name, for each (l, l) slab of the
(t*l, nb*l) row panel, a store row and its orientation (FLAG_STORE,
FLAG_TRANS, FLAG_EYE). The kernel (csrc/densify.cu) writes the panel
straight in its dtype (f32, or bf16 rounded to nearest even), applying
the flags as it writes; `densify_panel_plain` does the same with
ops/sparse.densify, a transpose and a cast. Each panel cell takes at
most one value, so the two agree bit for bit. A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises. `LAUNCHES`
counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .sparse import densify

FLAG_STORE, FLAG_TRANS, FLAG_EYE = 0, 1, 2

LAUNCHES = {"densify": 0}

_fn = None


def reset_launches() -> None:
    LAUNCHES["densify"] = 0


def kernel_specs():
    from ..utils.build import cuda_spec
    return [cuda_spec("densify")]


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
