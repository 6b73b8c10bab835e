"""Emission builders of the Muscle-3D pair-HMM (torch port of
muscle_tpu.ops.emissions).

The kernels consume a precomputed (B, Lx, Ly) emission lattice plus
per-position insert scores. For Muscle-3D feature profiles (reference:
src/mega.cpp:273-361, src/fwdflat_mega.cpp):

    E[i, j] = sum_f w_f * logP_f[px[i, f], py[j, f]]
    ins[i]  = sum_f w_f * logfreq_f[px[i, f]]

summed over the features in their order, each product rounded before
its add, as the JAX package does. Table lookups are gathers here (the
JAX package's one-hot products select the same entries exactly).

Profiles are padded along L with letter 0 (scores are garbage in the
padded region but the kernels never read them).
"""

from __future__ import annotations

import numpy as np
import torch


def mega_feature_arrays(mega, device="cpu"):
    """(weights (F,), log_probs list, log_prob_mx list) as f32 tensors on
    `device` (per-feature alphabet sizes differ, so lists not stacks)."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (t(mega.weights), [t(a) for a in mega.log_probs],
            [t(m) for m in mega.log_prob_mx])


def mega_insert_scores(profs: torch.Tensor, weights, log_probs
                       ) -> torch.Tensor:
    """profs: (B, L, F) uint8 -> (B, L) f32 weighted insert scores."""
    total = torch.zeros(profs.shape[:2], dtype=torch.float32,
                        device=profs.device)
    for f, lp in enumerate(log_probs):
        total = total + weights[f] * lp[profs[:, :, f].long()]
    return total


def mega_emission_matrix(profx: torch.Tensor, profy: torch.Tensor,
                         weights, log_prob_mx) -> torch.Tensor:
    """(B, Lx, F), (B, Ly, F) profiles -> (B, Lx, Ly) emission lattice."""
    b, lx, _ = profx.shape
    ly = profy.shape[1]
    total = torch.zeros((b, lx, ly), dtype=torch.float32,
                        device=profx.device)
    for f, mx in enumerate(log_prob_mx):
        sel = mx[profx[:, :, f].long()[:, :, None],
                 profy[:, :, f].long()[:, None, :]]
        total += sel.mul_(weights[f])
        del sel
    return total


def pad_profiles(profiles: list[np.ndarray], pad_to: int) -> np.ndarray:
    """list of (L_i, F) -> (N, pad_to, F) uint8 (the caller keeps the
    lengths)."""
    n = len(profiles)
    f = profiles[0].shape[1]
    out = np.zeros((n, pad_to, f), dtype=np.uint8)
    for i, p in enumerate(profiles):
        out[i, :p.shape[0]] = p
    return out
