"""The NW Viterbi and SW score kernels (ops/dp_cuda.py) on the card.

Marked `cuda`: they need a CUDA device and nvcc, and skip elsewhere.
This file imports neither jax nor muscle_tpu:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda_dp.py

Each kernel equals its plain version (ops/nw.nw_viterbi_plain,
ops/sw.sw_scores_plain) bit for bit: on ragged amino pairs at pads that
give one to twenty columns a thread, on lx = 0 / ly = 0 and one-residue
pairs, on codes outside the table (clamped, as the plain versions do)
and on a nucleotide table; the wrappers reject what the kernels do not
take.
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.ops import dp_cuda, nw, sw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _args(b, bx, by, seed, dev, k1=21, lo=1):
    rng = np.random.default_rng(seed)
    lx = rng.integers(lo, bx + 1, b).astype(np.int32)
    ly = rng.integers(lo, by + 1, b).astype(np.int32)
    lx[0], ly[0] = bx, by
    xb = np.full((b, bx), k1 - 1, np.int32)
    yb = np.full((b, by), k1 - 1, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, k1, lx[i])
        yb[i, :ly[i]] = rng.integers(0, k1, ly[i])
    subst = (sw.BLOSUM62_21 if k1 == 21 else
             rng.normal(0, 1, (k1, k1)).astype(np.float32))
    return (tuple(torch.from_numpy(a).to(dev) for a in (xb, yb, lx, ly))
            + (torch.as_tensor(subst, device=dev),))


def _same(args):
    bits, fin, sc = dp_cuda.nw_viterbi(*args)
    pb, pf, ps = nw.nw_viterbi_plain(*args)
    assert torch.equal(bits, pb)
    assert torch.equal(fin.view(torch.int32), pf.view(torch.int32))
    assert torch.equal(sc.view(torch.int32), ps.view(torch.int32))
    got, want = dp_cuda.sw_scores(*args), sw.sw_scores_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bx,by", [(40, 40), (128, 100), (100, 128),
                                   (384, 384), (64, 1024), (64, 1100),
                                   (32, 4095), (16, 20479)])
def test_kernels_equal_plain(cuda_device, bx, by):
    before = dict(dp_cuda.LAUNCHES)
    _same(_args(6, bx, by, bx + by, cuda_device))
    assert dp_cuda.LAUNCHES == {k: v + 1 for k, v in before.items()}


@pytest.mark.cuda
def test_edges_equal_plain(cuda_device):
    """Empty and one-residue sides, a width of one lane, codes outside
    the table, a 5-letter table."""
    args = _args(5, 12, 9, 1, cuda_device, lo=0)
    args[2][1] = 0
    args[3][2] = 0
    args[2][3] = args[3][3] = 1
    _same(args)
    _same(_args(3, 7, 1, 2, cuda_device))
    xb, yb, lx, ly, subst = _args(4, 30, 30, 3, cuda_device)
    _same((xb * 2 - 5, yb + 7, lx, ly, subst))
    _same(_args(4, 50, 60, 4, cuda_device, k1=5))


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    xb, yb, lx, ly, subst = _args(2, 8, 8, 5, cuda_device)
    for bad in ((xb.long(), yb, lx, ly, subst),
                (xb, yb, lx, ly, subst.double()),
                (xb, yb, lx[:1], ly, subst),
                (xb, yb, lx, ly, torch.zeros((33, 33), device=cuda_device))):
        for fn in (dp_cuda.nw_viterbi, dp_cuda.sw_scores):
            with pytest.raises(ValueError):
                fn(*bad)
    wide = torch.zeros((1, dp_cuda.MAX_WIDTH), dtype=torch.int32,
                       device=cuda_device)
    with pytest.raises(ValueError, match="lanes"):
        dp_cuda.nw_viterbi(xb[:1], wide, lx[:1], ly[:1], subst)
