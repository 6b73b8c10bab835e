"""Kernel 3K's corner output (-testfb) and the store kernels at K = 16
(MPC's sparse_k), on the card; the corner's plain version on the CPU.

The tests marked `cuda` need a CUDA device and nvcc; they skip
elsewhere. This file imports neither jax nor muscle_tpu:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda_surface.py

* 3K's corner output (the five backward states at the reversed
  lattice's far corner) equals `bwd_rows`' on one block a pair (4 x 512)
  and on the wave (16 x 2048), with pairs whose lx is the padded Lx (a
  multiple of 128), and the RB_M it returns with it equals the one
  without it;
* ops/testfb.total_probs on the card (kernels A and 3K) equals the plain
  versions' totals on the same tensors;
* kernel 8 (densify) and kernel 7 (densify_reduce) on stores of K = 16
  slots equal their plain versions.
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import testfb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _batch(b, lx_max, width, seed, device):
    """b random amino pairs: x up to lx_max letters in round_up(lx_max,
    128) columns (pair 0 exactly lx_max), y up to width in width; the
    default tables."""
    rng = np.random.default_rng(seed)
    lx_pad = -(-lx_max // 128) * 128
    lx = rng.integers(max(8, lx_max // 3), lx_max + 1, size=b).astype(np.int32)
    ly = rng.integers(max(8, width // 3), width + 1, size=b).astype(np.int32)
    lx[0], ly[0] = lx_max, width
    xb = np.full((b, lx_pad), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), device)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (xb, yb, lx, ly)) + tabs


def test_corner_plain_keeps_rbm_and_reaches_lx_at_the_pad():
    """On the CPU: corner=True returns the same RB_M as without it and a
    finite corner for every pair; where lx equals the padded Lx (pair 0:
    the step past RB_M's last row) the corner is the one computed with
    a wider pad. The wrapper runs the plain version, counting no launch."""
    args = _batch(3, 128, 256, 1, "cpu")
    before = dict(pc.LAUNCHES)
    rb = pc.pairhmm_bwd_codes(*args)
    rb2, far = pc.pairhmm_bwd_codes(*args, corner=True)
    assert pc.LAUNCHES == before
    assert torch.equal(rb, rb2)
    assert far.shape == (3, 5) and bool(torch.isfinite(far).all())
    assert int(args[2][0]) == args[0].shape[1] == 128
    wide = (torch.nn.functional.pad(args[0], (0, 128), value=20),) + args[1:]
    _, far_wide = pc.pairhmm_bwd_codes(*wide, corner=True)
    assert torch.equal(far_wide, far)


@pytest.mark.cuda
@pytest.mark.parametrize("b,width,schedule", [(4, 512, "block"),
                                              (16, 2048, "wave")])
def test_bwd_codes_corner_matches_plain(cuda_device, b, width, schedule):
    from muscle_tpu_torch.ops import wavefront
    args = _batch(b, 128, width, width, cuda_device)
    assert pc.bwd_codes_geometry(b, width).schedule == schedule
    before = pc.LAUNCHES["pairhmm_bwd_codes"]
    rb = pc.pairhmm_bwd_codes(*args)
    rb2, far = pc.pairhmm_bwd_codes(*args, corner=True)
    torch.cuda.synchronize()
    wavefront.check_waits(cuda_device)
    assert pc.LAUNCHES["pairhmm_bwd_codes"] == before + 2
    want_rb, want = pc.bwd_codes_plain(*args, corner=True)
    assert torch.equal(far, want)
    lx, ly = args[2], args[3]
    r = torch.arange(rb.shape[1], device=cuda_device)[None, :, None]
    c = torch.arange(rb.shape[2], device=cuda_device)[None, None, :]
    real = (r < lx[:, None, None]) & (c < ly[:, None, None])
    for got in (rb, rb2):
        assert torch.equal(got.where(real, 0.0), want_rb.where(real, 0.0))
        for k, n in enumerate(lx.tolist()):
            assert not got[k, n:].any()


@pytest.mark.cuda
def test_total_probs_on_card_match_plain(cuda_device):
    rng = np.random.default_rng(4)
    lens = [(128, 97), (60, 256), (300, 290)]
    xs = [rng.integers(0, 20, size=a) for a, _ in lens]
    ys = [rng.integers(0, 20, size=b) for _, b in lens]
    pack = HMMParams.from_defaults().to_scores()
    fwd, bwd = testfb.total_probs(xs, ys, pack, cuda_device)
    args = testfb.pair_batch(xs, ys, pack, cuda_device)
    _, fend = pc.fwd_plain(*args)
    _, far = pc.bwd_codes_plain(*args, corner=True)
    assert np.array_equal(fwd, pc._total_prob(fend, args[-1]).cpu().numpy())
    assert np.array_equal(bwd, pc._total_prob(far, args[-1]).cpu().numpy())
    assert np.all(np.abs(fwd - bwd) <= 1e-3 * np.maximum(1.0, np.abs(fwd)))


def _store(rng, p1, l, k, max_nnz):
    cols = np.argsort(rng.random((p1, l, l)), axis=-1)[..., :k].astype(
        np.int32)
    nnz = rng.integers(1, max_nnz + 1, size=(p1, l, 1))
    valid = np.arange(k) < nnz
    valid[-1] = False
    vals = np.where(valid, rng.random((p1, l, k)) * 0.9 + 0.02, 0.0)
    return vals.astype(np.float32), np.where(valid, cols, -1).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_store_kernels_at_k16_match_plain(cuda_device, dtype):
    """Kernel 8 on every z-tile of a 13-sequence Gram panel and kernel 7
    on a 9 x 40 join grid, over one store of K = 16 slots (rows with up
    to 16 valid), bit for bit."""
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import densify_cuda as dc
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    rng = np.random.default_rng(16)
    n, l, k = 13, 256, 16
    p1 = n * (n - 1) // 2 + 1
    vals, cols = _store(rng, p1, l, k, 16)
    v, c = (torch.from_numpy(a).to(cuda_device) for a in (vals, cols))
    pid, flag = cons._block_maps(n, 16, p1 - 1)
    for zi in range(-(-n // 4)):
        zs = slice(zi * 4, (zi + 1) * 4)
        p = torch.from_numpy(pid[zs]).to(cuda_device)
        f = torch.from_numpy(flag[zs]).to(cuda_device)
        assert torch.equal(dc.densify_panel(v, c, p, f, dtype),
                           dc.densify_panel_plain(v, c, p, f, dtype))
    n_r, n_c, cc = 9, 40, 700
    gp = rng.integers(0, p1 - 1, size=(n_r, n_c)).astype(np.int32)
    gp[rng.random((n_r, n_c)) < 0.3] = p1 - 1
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n_c)]).astype(np.int32)
    gp_t, bank_t = (torch.from_numpy(a).to(cuda_device) for a in (gp, bank))
    got = djc.densify_reduce(v, c, k, gp_t, bank_t, p1 - 1, cc)
    want = djc.densify_reduce_plain(v, c, k, gp_t, bank_t, p1 - 1, cc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
