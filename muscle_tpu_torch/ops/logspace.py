"""Log-space arithmetic for the pair-HMM (torch port of muscle_tpu.ops.logspace).

The reference computes Forward/Backward in fp32 log space using a
3-segment-per-branch cubic polynomial approximation of log(1+e^x)
("LOGEXP1", reference: src/scoretype.h:100-149) instead of log1p/exp.

Conventions (reference: src/scoretype.h:83-96):
    LOG_ZERO = -2e20   (additive identity; "probability zero")
    x + y in log space = LOG_ADD(x, y) ~= log(e^x + e^y)
    LOG_ADD returns max(x,y) when |x-y| >= 7.5 or min is LOG_ZERO.

The Horner steps of the cubic are evaluated as fused multiply-adds
(product and sum rounded once, emulated through float64 whose 53-bit
mantissa holds the exact f32 product): the JAX package's CPU path runs
the same expression through XLA, which contracts each multiply-add into
an FMA, so this keeps the port's CPU scan on the same bits.

`exp_f32` is an exp made of elementwise IEEE operations only. On the
CPU, torch.exp calls MKL's vector math, whose first call on a worker
thread of torch's pool now and then returns that thread's whole chunk
at ~1e-4 relative error (tools/torch_scan_repro.py shows it); the
posterior's exp goes through `exp_f32` instead, which gives the same
bits on every thread layout.
"""

from __future__ import annotations

import torch

LOG_ZERO = -2e20
LOG_UNDERFLOW = 7.5

# Cubic coefficients for log(1+e^x) on [0, 1], (1, 2.5], (2.5, 4.5], (4.5, 7.5]
# (reference: src/scoretype.h:100-109)
_C0 = (-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741)
_C1 = (-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976)
_C2 = (-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009)
_C3 = (-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057)


def _f32(c: float) -> float:
    """A Python float rounded to the nearest f32 (XLA's weak-typed constant)."""
    return float(torch.tensor(c, dtype=torch.float32))


_SEGS = tuple(tuple(_f32(c) for c in seg) for seg in (_C0, _C1, _C2, _C3))
_seg_tables: dict = {}


def logexp1(x):
    """log(1 + e^x) for x in [0, 7.5] via the reference's cubic splines.

    Each element's segment coefficients are looked up first, then one
    Horner chain runs: the same operations on the same values as
    evaluating all four cubics and selecting the result."""
    if x.device not in _seg_tables:
        _seg_tables[x.device] = torch.tensor(_SEGS, dtype=torch.float64,
                                             device=x.device)
    seg = (x > 1.0).long() + (x > 2.5).long() + (x > 4.5).long()
    c = _seg_tables[x.device][seg]
    xd = x.double()
    r = c[..., 0]
    for i in (1, 2, 3):
        r = (r * xd + c[..., i]).float().double()
    return r.float()


# Cody-Waite split of ln 2 and the degree-6 minimax polynomial of
# Cephes expf (cephes/single/expf.c)
_LOG2E = 1.44269504088896341
_LN2_HI = 0.693359375
_LN2_LO = -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x):
    """e^x for f32 x in [-87, 0], within ~1 ulp, from elementwise
    f32 multiplies and adds only (no library call, no fused steps)."""
    k = torch.round(x * _LOG2E)
    r = x - k * _LN2_HI
    r = r - k * _LN2_LO
    p = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        p = p * r + c
    p = p * (r * r) + r + 1.0
    two_k = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * two_k


def log_add(x, y):
    """LOG_ADD(x, y) with the reference's underflow clamps."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    small = (lo <= LOG_ZERO) | (d >= LOG_UNDERFLOW)
    # clamp the polynomial argument so the garbage lane of the select is finite
    corr = logexp1(torch.clamp(d, 0.0, LOG_UNDERFLOW))
    return torch.where(small, hi, lo + corr)


def log_add5(x1, x2, x3, x4, x5):
    """Right-fold LOG_ADD of five terms, reference association order
    (src/scoretype.h:137-140)."""
    return log_add(x1, log_add(x2, log_add(x3, log_add(x4, x5))))
