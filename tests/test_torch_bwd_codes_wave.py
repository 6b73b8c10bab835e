"""Kernel 3K, the letter path's legacy backward, on its two schedules
(ops/pairhmm_cuda.py::pairhmm_bwd_codes, csrc/pairhmm_bwd_codes.cu).

Kernel 3K runs kernels A and B's two schedules (`bwd_codes_geometry`):
one block a pair up to 704 lanes, and up to BWD_CODES_WAVE_MIN_LY =
1024 for more than BWD_CODES_WAVE_MAX_B = 128 pairs (pairhmm_bwd.cuh's
block body, which skips the segments past ly), the wave otherwise
(pairhmm_wave.cuh's backward body in kernel 3's layout, the
body kernel 3 runs from the emission lattice). On the letter lattice
match[x_i, y_j] kernel 3K is kernel 3, so kernel 3's wave twin,
`bwd_wave_plain`, is 3K's on the wave. What runs here: the schedule and
G at the rungs; the wrapper's wave arguments on a stand-in for the
library; `bwd_wave_plain` on the letter lattice against
`bwd_codes_plain` bit for bit at 2176 and 4096, with one table set and
one a pair. The JAX anchor of `bwd_codes_plain` (the Pallas
`_bwd_kernel` with kk=K): tests/test_torch_ensemble_kernels.py. The
CUDA kernel: tests/test_torch_cuda.py
(`test_multi_and_legacy_kernels_match_plain`,
`test_bwd_codes_wave_matches_plain`), on the card.
"""

import ctypes

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm as ph
from muscle_tpu_torch.ops import pairhmm_cuda as pc
from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
from muscle_tpu_torch.ops import wavefront


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("b", [1, 4, 128, 129, 512])
@pytest.mark.parametrize("width,want", [
    (128, pc.ABGeometry("block")), (384, pc.ABGeometry("block")),
    (512, pc.ABGeometry("block")), (704, pc.ABGeometry("block")),
    (768, pc.ABGeometry("wave", 4, 3)), (1024, pc.ABGeometry("wave", 4, 4)),
    (1152, pc.ABGeometry("wave", 3, 6)),
    (2048, pc.ABGeometry("wave", 4, 8)),
    (2176, pc.ABGeometry("wave", 2, 17)),
    (4096, pc.ABGeometry("wave", 4, 16)),
    (10240, pc.ABGeometry("wave", 4, 40))])
def test_schedule_at_the_rungs(width, want, b):
    """One block a pair up to 704 lanes, and at 768-1024 lanes for more
    than 128 pairs; the wave otherwise, in groups of the largest divisor
    of the segments up to 4; a schedule or G given is taken, but the
    block body (one segment a warp) only up to 2048 lanes."""
    if (pc.BWD_CODES_FEW_MIN_LY <= width <= pc.BWD_CODES_WAVE_MIN_LY
            and b > pc.BWD_CODES_WAVE_MAX_B):
        want = pc.ABGeometry("block")
    assert pc.bwd_codes_geometry(b, width) == want
    assert pc.bwd_codes_geometry(b, width, "wave", 1) == pc.ABGeometry(
        "wave", 1, width // 64)
    if width <= pc.WAVE_MIN_LY:
        assert pc.bwd_codes_geometry(b, width, "block") == pc.ABGeometry(
            "block")
    else:
        with pytest.raises(ValueError):
            pc.bwd_codes_geometry(b, width, "block")


def _letters(b, n_rows, width, seed, per_pair):
    """(xb, yb, lxb, lyb, match, insert, params) of b random amino pairs,
    lx < n_rows and ly < width but for the first pair, wildcard-padded;
    one table set, or four perturbed packs mixed lane by lane."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(n_rows // 2, n_rows + 1, size=b).astype(np.int32)
    ly = rng.integers(width // 2, width + 1, size=b).astype(np.int32)
    lx[0], ly[0] = n_rows, width
    xb = np.full((b, n_rows), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    codes = tuple(torch.from_numpy(a) for a in (xb, yb, lx, ly))
    if not per_pair:
        return codes + pc.tables(
            HMMParams.from_defaults(nucleo=False).to_scores(), "cpu")
    packs = []
    for s in (0, 1, 2, 3):
        hp = HMMParams.from_defaults(nucleo=False)
        if s:
            hp.perturb(s)
        packs.append(hp.to_scores())
    m, i, s, t = ph.score_args_multi(packs, [k % 4 for k in range(b)], "cpu")
    return codes + (m.contiguous(), i.contiguous(), pc.params_rows(s, t))


def _lattice(args):
    """Kernel 3's inputs from 3K's: the letter lattice match[x_i, y_j]
    (each pair's own table for per-pair tables), the insert scores of
    the letters, the same lengths and params."""
    xb, yb, lx, ly, match, insert, params = args
    x, y = xb.long(), yb.long()
    if match.dim() == 2:
        e = match[x[:, :, None], y[:, None, :]]
        ins_x, ins_y = insert[x], insert[y]
    else:
        ar = torch.arange(x.shape[0])
        e = match[ar[:, None, None], x[:, :, None], y[:, None, :]]
        ins_x = torch.gather(insert, 1, x)
        ins_y = torch.gather(insert, 1, y)
    return (e.contiguous(), ins_x.contiguous(), ins_y.contiguous(), lx, ly,
            params)


@pytest.mark.parametrize("per_pair", [False, True], ids=["shared",
                                                         "per-pair"])
@pytest.mark.parametrize("width", [2176, 4096])
def test_wave_on_the_letter_lattice_equals_bwd_codes_plain(width, per_pair):
    """3K on the wave: kernel 3's wave twin at the geometry's G on the
    letter lattice gives bwd_codes_plain's RB_M bit for bit (every cell,
    rows u >= lx zero)."""
    args = _letters(3, 40, width, width + per_pair, per_pair)
    want = pc.bwd_codes_plain(*args)
    g = pc.bwd_codes_geometry(3, width).g
    assert torch.equal(pe.bwd_wave_plain(*_lattice(args), g), want)


class _FakeLib:
    """Stands in for the kernel library: records a launch's arguments."""

    def __init__(self):
        self.calls = []

    def pairhmm_bwd_codes(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("width,schedule,g_arg,g", [
    (512, None, None, 0), (512, "wave", None, 4), (1024, None, None, 4),
    (1024, "block", None, 0), (2048, None, None, 4),
    (2048, "block", None, 0), (2176, None, None, 2), (4096, "wave", 2, 2)])
def test_wrapper_passes_the_schedule(monkeypatch, width, schedule, g_arg, g):
    """The wrapper launches the block body (G = 0, null buffers) or the
    wave (G, R, the watchdog's limit, a zeroed ticket and counters, the
    records, the fault flag, row 0's 4 B Ly floats) as
    `bwd_codes_geometry` picks, or the schedule and G it is given; it
    counts the launch by schedule and width."""
    fake = _FakeLib()
    made = {}
    real_args = pc._wave_args

    def wave_args(*a):
        out, bufs = real_args(*a)
        made["bufs"] = bufs
        return out, bufs
    monkeypatch.setattr(pc, "_on_card", lambda t: True)
    monkeypatch.setattr(pc, "_lib", lambda name: fake)
    monkeypatch.setattr(pc, "_stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(pc, "_wave_args", wave_args)
    args = _letters(2, 24, width, 1, True)
    before = pc.SCHEDULES.copy()
    rb = pc.pairhmm_bwd_codes(*args, schedule=schedule, g=g_arg)
    assert rb.shape == (2, 24, width)
    call = fake.calls[0]
    assert call[7:12] == (1, 2, 24, width, 21)
    geo = pc.bwd_codes_geometry(2, width, schedule, g_arg)
    assert call[12] == g == geo.g
    key = ("pairhmm_bwd_codes", geo.schedule, width)
    assert pc.SCHEDULES[key] == before[key] + 1
    if g == 0:
        assert call[13:15] == (0, 0) and made["bufs"] == ()
        return
    assert call[13:15] == (wavefront.ROWS_PER_PUBLISH,
                           wavefront.WAIT_LIMIT_NS)
    sync, fault, hand, row0 = made["bufs"]
    assert not sync.any() and sync.numel() == 1 + 2 * geo.groups
    assert fault.data_ptr() == wavefront.fault_flag("cpu").data_ptr()
    assert hand.numel() * 4 == wavefront.hand_bytes(2, geo.groups, 24, "bwd")
    assert row0.numel() == 4 * 2 * width


@pytest.mark.parametrize("width,schedules", [(2176, (None, "wave")),
                                              (1024, (None, "block"))])
def test_cpu_tensors_run_the_plain_version(width, schedules):
    """On CPU tensors the wrapper runs bwd_codes_plain on either schedule
    and counts nothing; the block body is refused beyond 2048 lanes on
    CPU tensors too."""
    args = _letters(2, 30, width, 5, False)
    launches, scheds = dict(pc.LAUNCHES), pc.SCHEDULES.copy()
    want = pc.bwd_codes_plain(*args)
    for schedule in schedules:
        assert torch.equal(pc.pairhmm_bwd_codes(*args, schedule=schedule),
                           want)
    assert pc.LAUNCHES == launches and pc.SCHEDULES == scheds
    if width > pc.WAVE_MIN_LY:
        with pytest.raises(ValueError):
            pc.pairhmm_bwd_codes(*args, schedule="block")
