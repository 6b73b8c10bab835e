"""The size limits the JAX package set for a 16 GB TPU, as the port
derives them from the card's memory (utils/device.device_memory_bytes):

* on the CPU (no card) the port's MPC store guard raises MemoryError on
  exactly the inputs where muscle_tpu's raises: a 20-sequence family of
  length 1000 (pad 1024, n * pad = 20,480 > SMALL_DENSE_NL, the blocked
  branch) under MUSCLE_TPU_HBM_BUDGET_GB = 0.01 (both raise) and 1 (both
  go on to the pair stage), a 12-sequence family on the blocked branch
  under 0.0001 (both raise) and 1 (both run, texts equal); with no
  override, the JAX package's 12 GB;
* with the helper standing for an 80 GB card, the derived guard admits
  n = 440 at pad 512 (a store past the JAX package's 12 GB), and at each
  other fitted pad the first n past 12 GB and its fitted limit's n - 1,
  and raises at the limit before any pair is computed; it admits every
  store the JAX package's rule admits, on a card of little memory too,
  and keeps that rule at the pads and K it was not fitted at;
* tools/torch_size_probe.py --fit draws one line a pad over saved runs
  (no card);
* with the same card, the long-pair router sends pairs past
  _STRIPED_CELL_BUDGET (26,000² and titin's 34,350²) to kernels 5/6 in
  groups that fit the card's available memory, keeps the groups of 8
  within the budget (20,000²), and sends a pair that cannot fit alone to
  the scan; off the card every pair past the budget takes the scan, as
  muscle_tpu's CPU backend does;
* the helper reads no card where there is none: None for the CPU, a
  raise for a card that is not there.
"""

import numpy as np
import pytest
import torch

from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.pipeline import mpc as j_mpc
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu.sequence import MultiSequence as JMS
from muscle_tpu_torch import align
from muscle_tpu_torch.ops import pairhmm_striped as t_striped
from muscle_tpu_torch.pipeline import mpc as t_mpc
from muscle_tpu_torch.pipeline import posteriors as t_post
from muscle_tpu_torch.sequence import MultiSequence
from muscle_tpu_torch.utils import device as t_device

# an NVIDIA H100 80GB HBM3 as torch.cuda.mem_get_info reads it: its
# total, and what a fresh process has available
CARD = (85_029_158_912, 84_484_128_768)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _family_text(n, length, seed):
    """n mutated copies of one random protein, each `length` long."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=length)
    aas = "ARNDCQEGHILKMFPSTWYV"
    lines = []
    for i in range(n):
        mut = base.copy()
        pos = rng.integers(0, length, size=int(rng.integers(0, length // 3)))
        mut[pos] = rng.integers(0, 20, size=len(pos))
        lines.append(f">s{i}\n{''.join(aas[c] for c in mut)}\n")
    return "".join(lines)


class PairStage(Exception):
    """Raised in place of the pair stage: the guard let the call on."""


def _outcome(run):
    try:
        return run().to_fasta_text()
    except MemoryError:
        return MemoryError
    except PairStage:
        return PairStage


@pytest.mark.parametrize("budget_gb,want", [("0.01", MemoryError),
                                            ("1", PairStage)])
def test_cpu_guard_decides_as_jax(monkeypatch, budget_gb, want):
    """20 sequences of length 1000 (store 50 MB): both guards raise under
    a 0.01 GB budget and both let the call on to the pair stage under
    1 GB (the pair stage itself, minutes on the CPU at this size, is
    replaced in both packages by a raise)."""
    monkeypatch.setenv("MUSCLE_TPU_HBM_BUDGET_GB", budget_gb)

    def pair_stage(*args, **kwargs):
        raise PairStage

    for mod in (t_post, j_post):
        monkeypatch.setattr(mod, "all_pairs_posteriors_sparse", pair_stage)
    text = _family_text(20, 1000, 20)
    assert [_outcome(run) for run in (
        lambda: align(MultiSequence.from_fasta_text(text), device="cpu"),
        lambda: j_mpc.MPC().run(JMS.from_fasta_text(text),
                                JHMMParams.from_defaults(nucleo=False),
                                "amino"))] == [want, want]


@pytest.mark.parametrize("budget_gb", ["0.0001", "1"])
def test_cpu_guard_raises_or_runs_as_jax(monkeypatch, budget_gb):
    """A family of 12 (L 30-60, pad 64) on the blocked branch
    (SMALL_DENSE_NL lowered in both packages; its store 1.1 MB): both
    raise under 0.0001 GB, both run to the same text under 1 GB."""
    monkeypatch.setenv("MUSCLE_TPU_HBM_BUDGET_GB", budget_gb)
    for mod in (t_post, j_post):
        monkeypatch.setattr(mod, "SMALL_DENSE_NL", 64)
    rng = np.random.default_rng(12)
    base = rng.integers(0, 20, 60)
    aas = "ARNDCQEGHILKMFPSTWYV"
    lines = []
    for i in range(12):
        mut = base[:int(rng.integers(30, 61))].copy()
        pos = rng.integers(0, len(mut), size=len(mut) // 4)
        mut[pos] = rng.integers(0, 20, size=len(pos))
        lines.append(f">s{i}\n{''.join(aas[c] for c in mut)}\n")
    text = "".join(lines)
    got = [_outcome(run) for run in (
        lambda: align(MultiSequence.from_fasta_text(text), refine_iters=2,
                      device="cpu"),
        lambda: j_mpc.MPC(refine_iters=2).run(
            JMS.from_fasta_text(text), JHMMParams.from_defaults(nucleo=False),
            "amino"))]
    if budget_gb == "0.0001":
        assert got == [MemoryError, MemoryError]
    else:
        assert isinstance(got[0], str) and got[0] == got[1]


def test_cpu_guard_keeps_the_jax_default(monkeypatch):
    """No override, no card: the JAX package's 12 GB, on the same store
    bytes ((P+1) * L * K * 8)."""
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    for n, raises in ((429, True), (428, False)):
        pairs = n * (n - 1) // 2
        assert ((pairs + 1) * 512 * 32 * 8 > 12e9) == raises
        if raises:
            with pytest.raises(MemoryError, match="12 GB budget"):
                t_mpc.store_guard(n, pairs, 512, 32, "cpu")
        else:
            t_mpc.store_guard(n, pairs, 512, 32, "cpu")


def _derived_limit(pad=512):
    """The first n at `pad`, K 32 the derived guard refuses on CARD."""
    n = 2
    while (t_mpc.store_peak(n * (n - 1) // 2, pad, 32)
           <= CARD[1] - t_device.MEMORY_HEADROOM):
        n += 1
    return n


def _past_12gb(pad, k=32):
    """The first n whose store passes the JAX package's 12 GB."""
    n = 2
    while (n * (n - 1) // 2 + 1) * pad * k * 8 <= 12e9:
        n += 1
    return n


def test_derived_guard_on_an_80gb_card(monkeypatch):
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(t_mpc, "device_memory_bytes", lambda device: CARD)
    limit = _derived_limit()
    assert 440 < limit
    t_mpc.store_guard(440, 440 * 439 // 2, 512, 32, "cuda")
    t_mpc.store_guard(limit - 1, (limit - 1) * (limit - 2) // 2, 512, 32,
                      "cuda")
    with pytest.raises(MemoryError, match="Use -super5"):
        t_mpc.store_guard(limit, limit * (limit - 1) // 2, 512, 32, "cuda")
    # the override still wins, as in the JAX package
    monkeypatch.setenv("MUSCLE_TPU_HBM_BUDGET_GB", "1000")
    t_mpc.store_guard(limit, limit * (limit - 1) // 2, 512, 32, "cuda")


def test_derived_guard_admits_what_jax_admits(monkeypatch):
    """A card with 4 GB available, below the line's base: every store
    within the JAX package's 12 GB still runs (n = 428 at pad 512), and
    the first past it (429) raises by the card's figure."""
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(t_mpc, "device_memory_bytes",
                        lambda device: (8_000_000_000, 4_000_000_000))
    t_mpc.store_guard(428, 428 * 427 // 2, 512, 32, "cuda")
    with pytest.raises(MemoryError, match="4.0 GB available"):
        t_mpc.store_guard(429, 429 * 428 // 2, 512, 32, "cuda")


@pytest.mark.parametrize("pad,k", [(4096, 32), (1536, 32), (512, 16)])
def test_derived_guard_only_at_the_fitted_shape(monkeypatch, pad, k):
    """On the 80 GB card, a pad or K no line was fitted at keeps the
    JAX package's 12 GB: the first n past it raises with its text."""
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(t_mpc, "device_memory_bytes", lambda device: CARD)
    assert t_mpc.store_peak(1000, pad, k) is None
    n = _past_12gb(pad, k)
    t_mpc.store_guard(n - 1, (n - 1) * (n - 2) // 2, pad, k, "cuda")
    with pytest.raises(MemoryError, match="12 GB budget"):
        t_mpc.store_guard(n, n * (n - 1) // 2, pad, k, "cuda")


# the pads fitted past pad 512 (pipeline/mpc.STORE_FITS)
FITTED_PADS = (768, 1024)
# their runs' reserved peaks in bytes on NVIDIA H100 80GB HBM3, 700 W
# (tools/torch_size_probe.py --peaks --pad P): (pad, family, n, peak)
MEASURED_PEAKS = (
    (768, "random", 357, 35_649_486_848),
    (768, "mutated", 357, 32_518_438_912),
    (768, "random", 446, 51_881_443_328),
    (768, "random", 558, 76_525_076_480),
    (1024, "mutated", 310, 40_743_469_056),
    (1024, "random", 310, 40_743_469_056),
    (1024, "mutated", 400, 69_189_238_784),
    (1024, "random", 400, 69_189_238_784),
    (1024, "mutated", 446, 70_799_851_520),
    (1024, "random", 446, 70_799_851_520),
)


@pytest.mark.parametrize("pad,family,n,peak", MEASURED_PEAKS)
def test_each_measured_peak_under_its_line(pad, family, n, peak):
    assert t_mpc.store_peak(n * (n - 1) // 2, pad, 32) >= peak


@pytest.mark.parametrize("pad", FITTED_PADS)
def test_derived_guard_at_each_fitted_pad(monkeypatch, pad):
    """On the 80 GB card, at a pad fitted past 512: the first n past
    12 GB runs, and so does the fitted limit's n - 1; the limit raises
    with its text, and under an explicit budget the JAX package's rule
    holds again."""
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(t_mpc, "device_memory_bytes", lambda device: CARD)
    first, limit = _past_12gb(pad), _derived_limit(pad)
    assert first < limit
    for n in (first, limit - 1):
        t_mpc.store_guard(n, n * (n - 1) // 2, pad, 32, "cuda")
    with pytest.raises(MemoryError, match=f"L={pad}, K=32\\): its .* Use "
                       "-super5"):
        t_mpc.store_guard(limit, limit * (limit - 1) // 2, pad, 32, "cuda")
    monkeypatch.setenv("MUSCLE_TPU_HBM_BUDGET_GB", "12")
    with pytest.raises(MemoryError, match="12 GB budget"):
        t_mpc.store_guard(first, first * (first - 1) // 2, pad, 32, "cuda")


def test_probe_fits_one_line_a_pad(tmp_path):
    """tools/torch_size_probe.py --fit on two saved runs a pad: each
    pad's line is the one through its two runs, the one line over both
    pads bounds every run, and each pad's line says whether it bounds
    the other pad's runs."""
    import importlib.util
    import json
    import os
    spec = importlib.util.spec_from_file_location(
        "size_probe", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "torch_size_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    runs = {512: ((10e9, 30e9), (20e9, 52e9)),
            1024: ((10e9, 33e9), (20e9, 56e9))}
    for pad, pts in runs.items():
        for i, (store, peak) in enumerate(pts):
            row = {"family": "random", "n": 300 + i, "pad": pad, "k": 32,
                   "store_alloc": store, "peak_reserved": peak,
                   "available": CARD[1]}
            with open(probe.peak_path(str(tmp_path), "random", 300 + i, pad),
                      "w") as f:
                json.dump(row, f)
    assert probe.fit_saved(str(tmp_path)) == 0
    with open(tmp_path / "size_probe_fit.json") as f:
        fit = json.load(f)
    lines = fit["lines"]
    assert set(lines) == {"512,32", "1024,32"}
    for pad, ((s0, p0), (s1, p1)) in runs.items():
        line = lines[f"{pad},32"]
        assert line["per_byte"] == pytest.approx((p1 - p0) / (s1 - s0))
        assert line["base"] == pytest.approx(p0 - line["per_byte"] * s0)
        assert line["limit_n"] == probe.limit_n(
            (line["per_byte"], line["base"]), pad, 32, CARD[1])
    assert not lines["512,32"]["bounds_every_pad"]
    assert lines["1024,32"]["bounds_every_pad"]
    one = fit["one_line"]
    assert all(one["per_byte"] * s + one["base"] >= p - 1
               for pts in runs.values() for s, p in pts)


def test_derived_guard_raises_before_the_pair_stage(monkeypatch):
    """align() of a family just past the derived limit (pad 512) raises
    MemoryError before any pair is computed."""
    monkeypatch.delenv("MUSCLE_TPU_HBM_BUDGET_GB", raising=False)
    monkeypatch.setattr(t_mpc, "device_memory_bytes", lambda device: CARD)
    limit = _derived_limit()

    def reached(*args, **kwargs):
        raise AssertionError("the pair stage was reached")

    monkeypatch.setattr(t_post, "all_pairs_posteriors_sparse", reached)
    rng = np.random.default_rng(7)
    aas = "ARNDCQEGHILKMFPSTWYV"
    text = "".join(f">s{i}\n{''.join(aas[c] for c in rng.integers(0, 20, 500))}\n"
                   for i in range(limit))
    with pytest.raises(MemoryError):
        align(MultiSequence.from_fasta_text(text), device="cpu")


def _long_lens():
    """A 26,000² pair, a 34,350² pair, then eight 20,000² pairs."""
    lens = np.array([26000, 26000, 34350, 34350] + [20000] * 16, np.int32)
    pairs = [(0, 1), (2, 3)] + [(4 + 2 * i, 5 + 2 * i) for i in range(8)]
    return lens, pairs


def _need(lx, ly, b=1):
    w = t_post._STRIPE_W
    return t_striped.striped_need_bytes(b, t_post._long_rung(lx),
                                        t_post.round_up(ly, w), w, 32)


def test_router_past_the_striped_budget_on_an_80gb_card(monkeypatch):
    lens, pairs = _long_lens()
    for lx in (26000, 34350):
        assert lx * lx > t_post._STRIPED_CELL_BUDGET
    assert 20000 * 20000 < t_post._STRIPED_CELL_BUDGET
    room = CARD[1] - t_device.MEMORY_HEADROOM
    monkeypatch.setattr(t_device, "free_bytes", lambda device: room)
    plan = t_post._long_pair_plan(lens, pairs, True, 32, "cuda")
    assert plan == [("striped", [0]), ("striped", [1]),
                    ("striped", list(range(2, 10)))]
    assert _need(34350, 34350) <= room and _need(26000, 26000) <= room
    assert _need(20000, 20000, 8) <= room

    # several pairs of one rectangle share a launch as far as they fit
    many = [(0, 1)] * 9
    plan = t_post._long_pair_plan(lens, many, True, 32, "cuda")
    sizes = [len(ch) for route, ch in plan]
    assert {route for route, _ in plan} == {"striped"} and sum(sizes) == 9
    assert all(_need(26000, 26000, b) <= room for b in sizes)
    assert max(sizes) == max(b for b in range(1, 9)
                             if _need(26000, 26000, b) <= room)

    # room for one titin lane: groups of one, and the 20,000² pairs in
    # the groups that fit; for none: titin's pair takes the scan
    one = _need(34350, 34350)
    lanes = max(b for b in range(1, 9) if _need(20000, 20000, b) <= one)
    assert lanes < 8
    twenty = [list(range(2, 10))[lo:lo + lanes] for lo in range(0, 8, lanes)]
    monkeypatch.setattr(t_device, "free_bytes", lambda device: one)
    plan = t_post._long_pair_plan(lens, [(2, 3), (2, 3)] + pairs[2:], True,
                                  32, "cuda")
    assert plan == ([("striped", [0]), ("striped", [1])]
                    + [("striped", ch) for ch in twenty])
    monkeypatch.setattr(t_device, "free_bytes", lambda device: one - 1)
    plan = t_post._long_pair_plan(lens, [(2, 3)] + pairs[2:], True, 32,
                                  "cuda")
    assert plan[-1] == ("scan", [0])
    assert [ch for _, ch in plan[:-1]] == [[t - 1 for t in ch] for ch in twenty]


def test_router_off_the_card_scans(monkeypatch):
    """No card: the JAX package's contract. The CPU scans every long pair;
    with the kernels forced on CPU tensors (as the router tests force
    them) a pair past the budget still takes the scan."""
    lens, pairs = _long_lens()
    assert t_post._long_pair_plan(lens, pairs, False, 32, "cpu") == [
        ("scan", [i]) for i in range(len(pairs))]
    assert t_post._long_pair_plan(lens, pairs, True, 32, "cpu") == [
        ("striped", list(range(2, 10))), ("scan", [0]), ("scan", [1])]


def test_memory_helper_reads_no_card_off_the_gpu():
    assert t_device.device_memory_bytes("cpu") is None
    assert t_device.device_memory_bytes(torch.device("cpu")) is None
    assert t_device.free_bytes("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_device.device_memory_bytes(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_device.device_memory_bytes("cuda")
        lens, pairs = _long_lens()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_post._long_pair_plan(lens, pairs, True, 32, None)
