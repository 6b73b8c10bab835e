"""Kernel 4, the MEA score, as a wavefront of row bands
(ops/pairhmm_emis_cuda.py::mea_scores, csrc/mea_scores.cu).

The kernel runs each pair's rows as bands of 32 (one a warp), a round of
up to 16 bands a block, the next round of the pair on another block
that reads the round's last row from device memory; blocks take tickets
in order. What runs here: the kernel's schedule step by step
(`mea_scores_wave_plain`: bands, rounds, tickets, the rings and the
link rows, raising on a read before its write) against the plain
version bit for bit, on seeded posteriors zero outside each pair's
(lx, ly), at several warps a block (so several blocks a pair) and at
residencies down to one block, and past 16384 lanes; the plain version
against the JAX package's `mea_scores_pallas` in interpret mode
(max and add only: tolerance 0); the wrapper's arguments (lyb, the
warps, the ticket and link buffers) on a stand-in for the library; the
constants the twin repeats from the source. The CUDA kernel:
tests/test_torch_cuda.py (`test_mea_scores_kernel_matches_plain`), on
the card.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.ops import devjoin_cuda as djc
from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
from muscle_tpu_torch.ops import wavefront

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(b, n_rows, width, seed, kind, lx=None, ly=None):
    """(post, lxb, lyb): a (b, n_rows, width) f32 posterior zero outside
    each pair's (lx, ly), random lengths from n_rows / 3 and width / 3
    up unless given; values uniform in [0, 1) or, tie-heavy, from {0,
    0.25, 0.5} (mostly 0: most cells tie)."""
    rng = np.random.default_rng(seed)
    if lx is None:
        lx = rng.integers(max(1, n_rows // 3), n_rows + 1, size=b)
    if ly is None:
        ly = rng.integers(max(1, width // 3), width + 1, size=b)
    lx, ly = np.asarray(lx), np.asarray(ly)
    if kind == "random":
        p = rng.random((b, n_rows, width), dtype=np.float32)
    else:
        p = rng.choice(np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5]),
                       size=(b, n_rows, width))
    r = np.arange(n_rows)[None, :, None]
    c = np.arange(width)[None, None, :]
    p = np.where((r < lx[:, None, None]) & (c < ly[:, None, None]), p, 0.0)
    return (torch.from_numpy(p.astype(np.float32)),
            torch.from_numpy(lx.astype(np.int32)),
            torch.from_numpy(ly.astype(np.int32)))


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("b,n_rows,width,warps,resident", [
    (3, 70, 128, None, None),     # one block a pair
    (3, 70, 128, 1, None),        # a block a band: links between all
    (2, 200, 96, 2, 1),           # 4 rounds a pair, one block at a time
    (4, 130, 144, 3, 2),          # ragged last rounds, two at a time
    (2, 600, 64, None, None),     # 19 bands: 16 then 3, one link
])
def test_schedule_equals_plain(kind, b, n_rows, width, warps, resident):
    """The kernel's schedule (rings, links, tickets) gives the plain
    version's bits, ties included, on posteriors zero outside (lx, ly)
    with lx < Lx and ly < Ly, whatever the warps a block and however
    few blocks are resident."""
    post, lx, ly = _post(b, n_rows, width, b * n_rows + width, kind)
    want = pe.mea_scores_plain(post)
    got = pe.mea_scores_wave_plain(post, lx, ly, warps, resident)
    assert torch.equal(got, want)


def test_schedule_past_16384_lanes():
    """A width past the block-per-pair kernel's 16384 lanes, few rows:
    two pairs, one a full 16512 x 40, one ragged."""
    post, lx, ly = _post(2, 40, 16512, 7, "random", lx=[40, 33],
                         ly=[16512, 16391])
    want = pe.mea_scores_plain(post)
    assert torch.equal(pe.mea_scores_wave_plain(post, lx, ly, 1), want)
    assert torch.equal(pe.mea_scores_wave_plain(post, lx, ly), want)


def test_schedule_edge_pairs():
    """One-row and one-column pairs and an empty one (score 0)."""
    post, lx, ly = _post(4, 64, 48, 3, "random", lx=[1, 64, 33, 0],
                         ly=[48, 1, 17, 20])
    want = pe.mea_scores_plain(post)
    for warps in (None, 1):
        assert torch.equal(pe.mea_scores_wave_plain(post, lx, ly, warps),
                           want)
    assert float(want[3]) == 0.0


@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("b,n_rows,width", [(8, 40, 128), (2, 24, 16512)])
def test_plain_equals_pallas_interpret(kind, b, n_rows, width):
    """The plain version against the JAX package's `mea_scores_pallas`
    (the Pallas `_mea_kernel`, interpret mode) on the same posterior:
    max and add only, so equal."""
    post, _, _ = _post(b, n_rows, width, n_rows + width, kind)
    want = j_pallas.mea_scores_pallas(
        jnp.asarray(post.numpy().transpose(1, 0, 2)), b, interpret=True)
    assert np.array_equal(pe.mea_scores_plain(post).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("b,lx,warps,rounds", [
    (8, 12288, 16, 24), (512, 512, 4, 4), (264, 512, 8, 2),
    (132, 512, 16, 1), (64, 2048, 16, 4), (4, 40, 2, 1), (1, 1, 1, 1),
    (3, 600, 16, 2)])
def test_warps_and_rounds(b, lx, warps, rounds):
    """At most one warp a band of 32 padded rows: 16 a block while the
    pairs' blocks of 16 fill fewer than two waves of 132 SMs (mega-long's
    chunk, Lx 12288, in 24 rounds a pair), 8 below three, else 4 (the
    letter route's 512 pairs at 512 in 4 rounds)."""
    assert pe.mea_scores_warps(b, lx) == warps
    assert pe.mea_scores_rounds(lx, warps) == rounds


class _FakeLib:
    """Stands in for the kernel library: records a launch's arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_wrapper_arguments(monkeypatch):
    """The wrapper passes the posterior, lxb and lyb, the sizes, the
    warps (given, or one a band up to 16), the watchdog's limit and the
    device's fault flag; it raises on a lyb that is not (B,) int32 and on
    a width that is not a multiple of 16; it counts the launch."""
    fake = _FakeLib()
    monkeypatch.setattr(pe, "_on_card", lambda t: True)
    monkeypatch.setattr(pe, "_lib", lambda name: (fake, None))
    monkeypatch.setattr(pe, "_stream", lambda t: ctypes.c_void_p(0))
    post, lx, ly = _post(3, 200, 128, 1, "random")
    before = pe.LAUNCHES["mea_scores"]
    out = pe.mea_scores(post, lx, ly, warps=2)
    assert out.shape == (3,) and pe.LAUNCHES["mea_scores"] == before + 1
    (p_post, p_lx, p_ly, b, n_rows, width, warps, wait, p_sync, p_fault,
     p_links, p_out, _) = fake.calls[0]
    assert (p_post.value, p_lx.value, p_ly.value, p_out.value) == (
        post.data_ptr(), lx.data_ptr(), ly.data_ptr(), out.data_ptr())
    assert (b, n_rows, width, warps) == (3, 200, 128, 2)
    assert wait == djc.MEA_WAIT_CYCLES
    assert p_fault.value == wavefront.fault_flag("cpu").data_ptr()
    for bad in (ly.long(), ly[:2].contiguous()):
        with pytest.raises(ValueError):
            pe.mea_scores(post, lx, bad)
    with pytest.raises(ValueError):
        pe.mea_scores(post[:, :, :120].contiguous(), lx, ly)
    # the default warps, from the device's SMs: one a band, at most 16
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {
                            "multi_processor_count": 132}))
    pe.mea_scores(post, lx, ly)
    assert fake.calls[-1][6] == pe.mea_scores_warps(3, 200) == 7


def test_wrapper_buffers():
    """A launch's ticket and link counts are zero, one a block (1 + B
    rounds); the link rows hold B (rounds - 1) rows of Ly floats (none
    for a one-round launch, where a one-float stand-in is passed)."""
    sync, links = pe.mea_scores_buffers(3, 200, 128, 2, "cpu")
    assert sync.dtype == torch.int32 and sync.numel() == 1 + 3 * 4
    assert not sync.any()
    assert links.dtype == torch.float32 and links.numel() == 3 * 3 * 128
    sync, links = pe.mea_scores_buffers(512, 512, 512, 16, "cpu")
    assert sync.numel() == 1 + 512 and links.numel() == 1


def test_cpu_tensors_run_the_plain_version():
    post, lx, ly = _post(3, 70, 128, 2, "tie-heavy")
    before = dict(pe.LAUNCHES)
    assert torch.equal(pe.mea_scores(post, lx, ly), pe.mea_scores_plain(post))
    assert pe.LAUNCHES == before


def test_constants_are_the_kernels():
    """The twin's constants are csrc/mea_scores.cu's (and its rings
    mea_dirs', from the header they share); 16 warps fit a block's
    227 KB with the ticket."""
    with open(os.path.join(ROOT, "muscle_tpu_torch", "csrc",
                           "mea_scores.cu")) as f:
        src = f.read()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                            src)}
    assert got["MAX_WARPS"] == pe.MEA_SCORES_MAX_WARPS
    assert got["LINK_HC"] == pe.MEA_SCORES_LINK_HAND
    assert got["LINK_HC"] % djc.MEA_CHUNK == 0
    assert '#include "mea_wave.cuh"' in src
    per_warp = (4 * 33 * djc.MEA_CHUNK * (djc.MEA_SLOTS + 1)
                + 8 * djc.MEA_RING + 4)
    assert per_warp * pe.MEA_SCORES_MAX_WARPS + 4 <= 232448
