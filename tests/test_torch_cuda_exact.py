"""The reference-order kernels (pairhmm_fwd_exact, pairhmm_bwd_exact) on
the card against their plain versions, bit for bit. Marked `cuda`: they
skip without a CUDA device. This file imports neither jax nor
muscle_tpu:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda_exact.py
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _letters(b, lo, hi, width_x, width_y, seed):
    rng = np.random.default_rng(seed)
    lx = rng.integers(lo, hi + 1, size=b).astype(np.int32)
    ly = rng.integers(lo, min(hi, width_y) + 1, size=b).astype(np.int32)
    lx[0], ly[0] = min(hi, width_x), min(hi, width_y)
    xb = np.full((b, width_x), 20, np.int32)
    yb = np.full((b, width_y), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    return xb, yb, lx, ly


def _inside(t, lx, ly, bwd):
    """t (B, Lx, Ly) zeroed outside the cells each kernel writes (rows and
    columns < lx, ly for the forward; <= for the backward)."""
    r = torch.arange(t.shape[1], device=t.device)[None, :, None]
    c = torch.arange(t.shape[2], device=t.device)[None, None, :]
    lx, ly = lx[:, None, None] + int(bwd), ly[:, None, None] + int(bwd)
    return t.where((r < lx) & (c < ly), 0.0)


def _hold(src, lx, ly, params):
    for fn, bwd in ((pec.pairhmm_fwd_exact, False),
                    (pec.pairhmm_bwd_exact, True)):
        lat, ends = fn(src, lx, ly, params)
        cpu = type(src)(*(t.cpu() for t in src))
        want, want_ends = fn(cpu, lx.cpu(), ly.cpu(), params.cpu())
        torch.cuda.synchronize()
        assert torch.equal(_inside(lat.cpu(), lx.cpu(), ly.cpu(), bwd),
                           _inside(want, lx.cpu(), ly.cpu(), bwd))
        assert torch.equal(ends.cpu(), want_ends)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 256, 256), (1, 2100, 300)],
                         ids=["16x256", "bands-2100x300"])
def test_letters_match_plain(cuda_device, shape):
    b, wx, wy = shape
    xb, yb, lx, ly = _letters(b, 40, max(wx, wy), wx, wy, seed=wx)
    match, insert, params = pc.tables(HMMParams.from_defaults().to_scores(),
                                      cuda_device)
    t = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, lx, ly)]
    _hold(pec.Letters(t[0], t[1], match, insert), t[2], t[3], params)


def _pairs_of(lens_x, lens_y, width_x, width_y, seed):
    rng = np.random.default_rng(seed)
    b = len(lens_x)
    xb = np.full((b, width_x), 20, np.int32)
    yb = np.full((b, width_y), 20, np.int32)
    for i in range(b):
        xb[i, :lens_x[i]] = rng.integers(0, 20, lens_x[i])
        yb[i, :lens_y[i]] = rng.integers(0, 20, lens_y[i])
    return (xb, yb, np.asarray(lens_x, np.int32),
            np.asarray(lens_y, np.int32))


def _hold_letters(device, arrays):
    match, insert, params = pc.tables(HMMParams.from_defaults().to_scores(),
                                      device)
    t = [torch.from_numpy(a).to(device) for a in arrays]
    _hold(pec.Letters(t[0], t[1], match, insert), t[2], t[3], params)


@pytest.mark.cuda
@pytest.mark.parametrize("lx", [1, 31, 33, 2100])
def test_edges_of_bands_match_plain(cuda_device, lx):
    """A pair of lx rows (one lane, a band short of one or one past, 66
    bands: rounds on several SMs) against ly of 1 to 4096 columns."""
    ly = [1, 2, 31, 33, 640, 2047, 4096]
    _hold_letters(cuda_device, _pairs_of([lx] * len(ly), ly, lx, 4096,
                                         seed=lx))


@pytest.mark.cuda
def test_mixed_lengths_match_plain(cuda_device):
    """170-row and 512-row pairs in one batch at pad 512: a short pair's
    blocks stop at its own bands."""
    lens = [170, 512, 171, 511, 185, 497, 170, 512]
    _hold_letters(cuda_device, _pairs_of(lens, lens[::-1], 512, 512,
                                         seed=170))


@pytest.mark.cuda
def test_long_pair_matches_plain(cuda_device):
    """One 8300 x 2000 pair (the long-pair router's exact route): 260
    bands in rounds across the SMs."""
    _hold_letters(cuda_device, _pairs_of([8300], [2000], 8320, 2048,
                                         seed=8300))


@pytest.mark.cuda
def test_per_pair_tables_match_plain(cuda_device):
    xb, yb, lx, ly = _letters(8, 40, 256, 256, 256, seed=8)
    packs = []
    for seed in range(8):
        hp = HMMParams.from_defaults()
        hp.perturb(seed + 1)
        packs.append(hp.to_scores())
    match = torch.stack([pc.tables(p, cuda_device)[0] for p in packs])
    insert = torch.stack([pc.tables(p, cuda_device)[1] for p in packs])
    params = torch.stack([pc.tables(p, cuda_device)[2] for p in packs])
    t = [torch.from_numpy(a).to(cuda_device) for a in (xb, yb, lx, ly)]
    _hold(pec.Letters(t[0], t[1], match, insert), t[2], t[3], params)


@pytest.mark.cuda
def test_lattice_matches_plain(cuda_device):
    rng = np.random.default_rng(384)
    b, w = 8, 384
    lx = rng.integers(100, w + 1, b).astype(np.int32)
    ly = rng.integers(100, w + 1, b).astype(np.int32)
    e = rng.normal(-0.5, 1.5, (b, w, w)).astype(np.float32)
    ix = rng.normal(-1.0, 0.3, (b, w)).astype(np.float32)
    iy = rng.normal(-1.0, 0.3, (b, w)).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda_device) for a in (e, ix, iy, lx, ly)]
    params = pc.params_vec(HMMParams.from_defaults().to_scores(),
                           cuda_device)
    _hold(pec.Lattice(*t[:3]), t[3], t[4], params)


@pytest.mark.cuda
def test_route_matches_cpu_route(cuda_device):
    """exact_posteriors on the card (the kernels, kernel 4) = on the CPU
    (the plain versions, pairhmm._mea_score), posteriors and EA."""
    xb, yb, lx, ly = _letters(16, 40, 256, 256, 256, seed=3)
    pack = HMMParams.from_defaults().to_scores()
    t = [torch.from_numpy(a) for a in (xb, yb, lx, ly)]
    post, ea = pec.batch_posteriors_exact(*(a.to(cuda_device) for a in t),
                                          pack)
    want, want_ea = pec.batch_posteriors_exact(*t, pack)
    torch.cuda.synchronize()
    assert torch.equal(post.cpu(), want) and torch.equal(ea.cpu(), want_ea)


@pytest.mark.cuda
def test_long_pair_route_matches_in_cap(cuda_device, monkeypatch):
    """The long-pair router's exact route on the card (a pair padded past
    LONG_PAIR_THRESHOLD, in one chunk and under a lowered chunk limit)
    = the pair alone on the in-cap exact route at another padding: store
    rows bit for bit, rows past lx empty, EA within 1e-6."""
    from muscle_tpu_torch.ops import pairhmm as ph
    from muscle_tpu_torch.ops import sparse as sp
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    monkeypatch.setattr(ph, "EXACT_ASSOC", True)
    rng = np.random.default_rng(8300)
    lens = np.array([8300, 600], np.int32)
    codes = np.full((2, 8320), 20, np.int32)
    for i, n in enumerate(lens):
        codes[i, :n] = rng.integers(0, 20, n)
    pack = HMMParams.from_defaults().to_scores()
    args = post_mod._pad_pairs(codes, lens, [(0, 1)], 8448, 768, 20,
                               cuda_device)
    post, ea = pec.batch_posteriors_exact(*args, pack)
    vals, cols, _ = sp.sparsify(post, 32)
    for limit in (post_mod._EXACT_LONG_BYTES, 1):
        monkeypatch.setattr(post_mod, "_EXACT_LONG_BYTES", limit)
        pec.reset_routes()
        sv, sc, ea_r, _ = post_mod._long_pairs_sparse(
            codes, lens, pack, [(0, 1)], 32, cuda_device)
        assert pec.ROUTES["long_pairs"] == 1
        assert torch.equal(sv[0, :8300].cpu(), vals[0, :8300].cpu())
        assert torch.equal(sc[0, :8300].cpu(), cols[0, :8300].cpu())
        assert not sv[0, 8300:].any()
        assert abs(float(ea_r[0]) - float(ea[0])) <= 1e-6
