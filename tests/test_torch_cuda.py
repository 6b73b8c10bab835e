"""The CUDA kernels of muscle_tpu_torch on the card.

The tests marked `cuda` need a CUDA device and nvcc; they skip
elsewhere. This file imports neither jax nor muscle_tpu, so it also
runs where JAX is not installed:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda.py

(MUSCLE_TPU_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
"""

import os

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _batch(b, lmax, width, seed, nucleo):
    nletters = 4 if nucleo else 20
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    ly = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    lx[0] = ly[0] = lmax
    xb = np.full((b, width), nletters, np.int32)
    yb = np.full((b, width), nletters, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, nletters + 1, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, nletters + 1, size=ly[i])
    return xb, yb, lx, ly


def test_kernel_build_flags(monkeypatch):
    """sm_90a, IEEE arithmetic (no fast math, no FMA contraction), a
    plain C interface; every spec keyed on its header too."""
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    for spec in pc.kernel_specs():
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert not any("fast_math" in f for f in spec.flags)
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        assert any(d.endswith("pairhmm_common.cuh") for d in spec.deps)


def test_cpu_tensors_run_the_twins_and_count_nothing():
    xb, yb, lx, ly = _batch(2, 60, 128, 0, False)
    pack = HMMParams.from_defaults().to_scores()
    before = dict(pc.LAUNCHES)
    post, ea = pc.batch_posteriors_cuda(*(torch.from_numpy(a) for a in
                                          (xb, yb, lx, ly)), pack)
    assert pc.LAUNCHES == before
    assert post.shape == (2, 128, 128) and ea.shape == (2,)
    assert bool(torch.isfinite(ea).all()) and bool((ea > 0).all())
    post0, ea0 = pc.batch_posteriors_cuda(*(torch.from_numpy(a) for a in
                                            (xb, yb, lx, ly)), pack,
                                          with_mea=False)
    assert torch.equal(post0, post) and not ea0.any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lmax,width,seed,nucleo", [
    (16, 300, 384, 5, False),
    (8, 1000, 1024, 6, True),
    (4, 2500, 2560, 7, False),
], ids=["amino-384", "nt-1024", "amino-2560"])
def test_kernels_match_twins(cuda_device, b, lmax, width, seed, nucleo):
    xb, yb, lx, ly = _batch(b, lmax, width, seed, nucleo)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=nucleo).to_scores(), cuda_device)
    launches = dict(pc.LAUNCHES)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, match, insert, params)
    rows = torch.arange(width, device=cuda_device)[None, :, None] \
        < lxt[:, None, None]
    assert float((fm - fm2).abs().where(rows, 0.0).max()) < 1e-3
    assert float((fend - fend2).abs().max()) < 1e-3
    tot = pc._total_prob(fend, params)
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    torch.cuda.synchronize()
    d = (post - post2).abs()
    flip = ((post == 0) | (post2 == 0)) & \
        (torch.maximum(post, post2) <= 0.0102)
    assert float(d.where(~flip, 0.0).max()) < 2e-3
    n = torch.minimum(lxt, lyt).float()
    assert float((mea / n - mea2 / n).abs().max()) < 2e-3
    assert pc.LAUNCHES["pairhmm_fwd"] == launches["pairhmm_fwd"] + 1
    assert pc.LAUNCHES["pairhmm_bwd_post"] == \
        launches["pairhmm_bwd_post"] + 1
    post0, _ = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                   tot, fm, with_mea=False)
    assert torch.equal(post0, post)


@pytest.mark.cuda
def test_wrapper_raises_on_unsupported_width(cuda_device):
    xb, yb, lx, ly = _batch(2, 60, 100, 0, False)
    with pytest.raises(ValueError):
        pc.batch_posteriors_cuda(
            *(torch.from_numpy(a).to(cuda_device) for a in (xb, yb, lx, ly)),
            HMMParams.from_defaults().to_scores())


@pytest.mark.cuda
def test_align_on_card_matches_golden(cuda_device):
    from muscle_tpu_torch import MultiSequence, align
    path = os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa")
    msa = align(MultiSequence.from_fasta(path, strip_gaps=True),
                device=cuda_device)
    gold = MultiSequence.from_fasta(path)
    assert {s.label: s.text() for s in msa} == \
        {s.label: s.text() for s in gold}
