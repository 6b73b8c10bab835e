"""Kernel 1E on the wave and kernel 8's tiles, on the card.

The tests marked `cuda` need a CUDA device and nvcc; they skip
elsewhere. This file imports neither jax nor muscle_tpu, so it runs on
the card where JAX is not installed:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda_1e_densify.py

* kernel 8 (csrc/densify.cu) against densify_panel_plain at L = 128,
  512 and 3072 in f32 and bf16, and on one long-L f32 tile;
* kernel 1E on the wave (csrc/pairhmm_wave.cuh, the lattice read a row
  ahead) against kernel A on the wave, fed the letter lattice
  match[x_i, y_j], on every real cell of fm, at 4096 and 10240;
* kernel 1E on the wave against fwd_emis_plain at small widths, at the
  geometry's G and at forced ones.
The CPU twins: tests/test_torch_fwd_wavefront.py,
tests/test_torch_densify_tiles.py.
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
from muscle_tpu_torch.ops import wavefront


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _real(t, lx, ly):
    r = torch.arange(t.shape[1], device=t.device)[None, :, None]
    c = torch.arange(t.shape[2], device=t.device)[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


def _store(rng, p1, l, k, max_row_nnz=5):
    """(p1, l, k) store, 0..max_row_nnz unique columns a row, valid slots
    first; the last row is the empty dump row."""
    cols = np.stack([rng.choice(l, max_row_nnz, replace=False)
                     for _ in range(p1 * l)]).reshape(p1, l, max_row_nnz)
    cnt = rng.integers(0, max_row_nnz + 1, size=(p1, l, 1))
    valid = np.arange(max_row_nnz) < cnt
    valid[-1] = False
    vals = np.zeros((p1, l, k), np.float32)
    cc = np.full((p1, l, k), -1, np.int32)
    vals[..., :max_row_nnz] = np.where(
        valid, rng.random((p1, l, max_row_nnz)) * 0.9 + 0.02, 0.0)
    cc[..., :max_row_nnz] = np.where(valid, cols, -1)
    return vals, cc


@pytest.mark.cuda
@pytest.mark.parametrize("l,n,nbp,dtype", [
    (128, 5, 8, torch.float32), (128, 5, 8, torch.bfloat16),
    (512, 4, 6, torch.float32), (512, 4, 6, torch.bfloat16),
    (3072, 3, 4, torch.float32), (3072, 3, 4, torch.bfloat16),
    (12288, 2, 3, torch.float32)],
    ids=["128-f32", "128-bf16", "512-f32", "512-bf16", "3072-f32",
         "3072-bf16", "12288-f32"])
def test_densify_tiles_match_plain(cuda_device, l, n, nbp, dtype):
    """Kernel 8 equals densify_panel_plain bit for bit on every z-tile of
    the family's maps (every flag, the dump row, a pid below 0)."""
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import densify_cuda as dc
    rng = np.random.default_rng(l + n)
    p1 = n * (n - 1) // 2 + 1
    vals, cols = _store(rng, p1, l, 8)
    v, c = (torch.from_numpy(a).to(cuda_device) for a in (vals, cols))
    pid, flag = cons._block_maps(n, nbp, p1 - 1)
    pid[0, -1] = -1    # a dump column
    before = dc.LAUNCHES["densify"]
    for zi in range(0, n, 2):
        p = torch.from_numpy(pid[zi:zi + 2].copy()).to(cuda_device)
        f = torch.from_numpy(flag[zi:zi + 2].copy()).to(cuda_device)
        got = dc.densify_panel(v, c, p, f, dtype)
        want = dc.densify_panel_plain(v, c, p, f, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)
    assert dc.LAUNCHES["densify"] == before + len(range(0, n, 2))


def _letters(b, lx_max, width, seed):
    rng = np.random.default_rng(seed)
    lx = rng.integers(lx_max // 2, lx_max + 1, size=b).astype(np.int32)
    ly = rng.integers(width - 700, width + 1, size=b).astype(np.int32)
    lx[0], ly[0] = lx_max, width
    xb = np.full((b, lx_max), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    return xb, yb, lx, ly


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4096, 10240])
def test_fwd_emis_wave_equals_kernel_a_wave(cuda_device, width):
    """Fed the letter lattice match[x_i, y_j] with insert[x_i],
    insert[y_j], kernel 1E on the wave gives kernel A's wave bits on
    every real cell of fm and in fend."""
    xb, yb, lx, ly = _letters(3, 192, width, width)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(HMMParams.from_defaults().to_scores(),
                                      cuda_device)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    e = match[x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    scheds = pc.SCHEDULES.copy()
    fm2, fend2 = pe.pairhmm_fwd_emis(e, insert[x.long()].contiguous(),
                                     insert[y.long()].contiguous(), lxt, lyt,
                                     params)
    torch.cuda.synchronize()
    wavefront.check_waits(cuda_device)
    assert pc.SCHEDULES - scheds == {("pairhmm_fwd_emis", "wave", width): 1}
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)


@pytest.mark.cuda
@pytest.mark.parametrize("width,g", [(256, 1), (640, 2), (640, 5),
                                     (2176, None), (4352, None), (4352, 1)])
def test_fwd_emis_wave_matches_plain(cuda_device, width, g):
    """Kernel 1E on the wave against fwd_emis_plain on a random lattice
    with ragged pairs, bit for bit on the real cells and fend."""
    rng = np.random.default_rng(width + (g or 0))
    b, rows = 4, 64
    lx = np.array([64, 1, 37, 63], np.int32)
    ly = np.array([width, width - 63, 1, width - 64], np.int32)
    e = rng.random((b, rows, width), dtype=np.float32) * 4 - 3
    ins_x = -1 - rng.random((b, rows), dtype=np.float32)
    ins_y = -1 - rng.random((b, width), dtype=np.float32)
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in (e, ins_x, ins_y, lx, ly))
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), cuda_device)
    fm, fend = pe.pairhmm_fwd_emis(*args, params, schedule="wave", g=g)
    torch.cuda.synchronize()
    wavefront.check_waits(cuda_device)
    fm2, fend2 = pe.fwd_emis_plain(*args, params)
    lxt, lyt = args[3], args[4]
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
