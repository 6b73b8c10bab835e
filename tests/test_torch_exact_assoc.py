"""MUSCLE_TPU_EXACT_ASSOC=1 in muscle_tpu_torch against muscle_tpu under
the same flag, on the CPU.

The flag is read at import in both packages, so each side runs as a
script in a subprocess (tests/_exact_assoc_jax.py, then
tests/_exact_assoc_port.py on the JAX side's inputs) and the checks
here compare their outputs:

* posteriors of ragged letter pairs, of pairs with their own perturbed
  tables and of a seeded emission lattice: max |d| <= 1e-6 (the
  lattices are the same bits; the posterior's exp may differ in the last
  place) with the same 0.01 pattern; EA and the -testfb totals within
  1e-6;
* the long pair through the checkpoint/recompute scan at a small row
  block, and through the long-pair router's exact route;
* the card's route assembled over the kernels' plain versions
  (ops/pairhmm_exact_cuda.exact_posteriors) equals the CPU scan bit for
  bit for letters, per-pair tables and the lattice;
* the naive per-cell oracle (tests/naive_oracle.py) within 1e-4 with
  the same pattern, as tests/test_exact_assoc.py holds the JAX package;
* BB11001 from its degapped golden: the port's text = the JAX package's
  = the golden.

In this process (flag unset): EXACT_ASSOC is off, and the anti-diagonal
plain versions equal the JAX package's scans under the flag bit for
bit (their lattices, end states and corners).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm as ph
from muscle_tpu_torch.ops import pairhmm_exact_cuda as pec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import naive_oracle as NO  # noqa: E402
from exact_assoc_cases import cases  # noqa: E402

GATE = 1e-6


def _run(script, d):
    r = subprocess.run([sys.executable, os.path.join(REPO, "tests", script),
                        d], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exact"))
    _run("_exact_assoc_jax.py", d)
    _run("_exact_assoc_port.py", d)

    def rows(name):
        from muscle_tpu_torch import MultiSequence
        return {s.label: s.text()
                for s in MultiSequence.from_fasta(os.path.join(d, name))}
    return (dict(np.load(os.path.join(d, "jax.npz"))),
            dict(np.load(os.path.join(d, "port.npz"))), rows)


def _close(want, got, ea_want, ea_got):
    assert np.abs(got - want).max() <= GATE
    assert np.array_equal(got > 0, want > 0)
    assert np.abs(ea_got - ea_want).max() <= GATE


@pytest.mark.parametrize("key", ["", "m_", "e_"],
                         ids=["letters", "per-pair-tables", "lattice"])
def test_posteriors_match_jax(runs, key):
    jx, pt, _ = runs
    _close(jx[f"{key}post"], pt[f"{key}post"], jx[f"{key}ea"],
           pt[f"{key}ea"])


@pytest.mark.parametrize("key", ["", "m_", "e_"],
                         ids=["letters", "per-pair-tables", "lattice"])
def test_card_route_equals_scan(runs, key):
    """exact_posteriors over the kernels' plain versions (what the card
    runs, kernel 4 aside) = the CPU scan, bit for bit."""
    _, pt, _ = runs
    assert np.array_equal(pt[f"{key}route_post"], pt[f"{key}post"])
    assert np.array_equal(pt[f"{key}route_ea"], pt[f"{key}ea"])


def test_testfb_totals_match_jax(runs):
    jx, pt, _ = runs
    for k in ("tot_fwd", "tot_bwd"):
        assert abs(float(pt[k]) - float(jx[k])) <= GATE, k
    assert abs(float(pt["tot_fwd"]) - float(pt["tot_bwd"])) <= \
        1e-3 * abs(float(pt["tot_fwd"]))


def test_long_pair_scan_matches_jax(runs):
    jx, pt, _ = runs
    assert np.array_equal(pt["long_cols"], jx["long_cols"])
    assert np.abs(pt["long_vals"] - jx["long_vals"]).max() <= GATE
    assert abs(float(pt["long_ea"]) - float(jx["long_ea"])) <= GATE
    assert abs(float(pt["long_total"]) - float(jx["long_total"])) <= GATE


def test_long_pair_exact_route_equals_scan(runs):
    """The long-pair router's exact route (the whole lattices) gives the
    checkpoint/recompute scan's store row for row."""
    _, pt, _ = runs
    assert int(pt["router_exact"]) == 1
    assert np.array_equal(pt["router_cols"], pt["long_cols"])
    assert np.array_equal(pt["router_vals"], pt["long_vals"])
    assert float(pt["router_ea"]) == float(pt["long_ea"])


def test_naive_oracle(runs):
    """The per-cell transcription of fwdflat3/bwdflat3 in float64/f32:
    within its own rounding floor, the same 0.01 pattern."""
    jx, pt, _ = runs
    pack = HMMParams.from_defaults().to_scores()

    class P:
        pass
    p2 = P()
    p2.insert, p2.match = np.asarray(pack.insert), np.asarray(pack.match)
    p2.start = np.asarray(pack.start)
    for nm in ("tMM", "tMI", "tMJ", "tII", "tIM", "tJJ", "tJM"):
        setattr(p2, nm, float(getattr(pack, nm)))
    lx, ly = int(jx["lx"][0]), int(jx["ly"][0])
    want, _total = NO.posterior(jx["xb"][0, :lx], jx["yb"][0, :ly], p2)
    got = pt["post"][0, :lx, :ly]
    assert np.abs(got - want).max() < 1e-4
    assert int(((got > 0) ^ (want > 0)).sum()) == 0


def test_bb11001_text(runs):
    from muscle_tpu_torch import MultiSequence
    _, _, rows = runs
    gold = {s.label: s.text() for s in MultiSequence.from_fasta(
        os.path.join(REPO, "tests", "goldens", "BB11001.seq.afa"))}
    assert rows("port.afa") == rows("jax.afa") == gold


def test_exact_assoc_defaults_off():
    if os.environ.get("MUSCLE_TPU_EXACT_ASSOC") == "1":
        pytest.skip("the flag is set for this run")
    assert not ph.EXACT_ASSOC


def _small():
    c = cases()
    pack = HMMParams.from_defaults().to_scores()
    match, insert, start, tv = ph.score_args(pack)
    xb, yb = torch.as_tensor(c["mxb"]), torch.as_tensor(c["myb"])
    lx, ly = torch.as_tensor(c["mlx"]), torch.as_tensor(c["mly"])
    return xb, yb, lx, ly, match, insert, start, tv


@pytest.mark.parametrize("key", ["ls_", "lp_"], ids=["shared", "per-pair"])
def test_wave_equals_jax_scan(runs, key):
    """fwd_exact_wave / bwd_exact_wave (the kernels' plain versions; they
    take the reference order whatever the mode) = the JAX package's
    scans under the flag: every cell of the M lattices inside each pair,
    the end states and the corner, bit for bit."""
    jx, _, _ = runs
    t = torch.as_tensor
    xb, yb = t(jx["mxb"]).long(), t(jx["myb"]).long()
    lx, ly = t(jx["mlx"]).long(), t(jx["mly"]).long()
    xr, yr = ph.reverse_padded(xb, lx).long(), ph.reverse_padded(yb, ly).long()
    if key == "ls_":
        match, insert, start, tv = ph.score_args(
            HMMParams.from_defaults().to_scores())
        match, insert = match[None], insert[None]
    else:
        match, insert, start, tv = (t(jx[k]) for k in (
            "m_match", "m_insert", "m_start", "m_tv"))
    r = torch.arange(match.shape[0])

    def emit(x, y):
        return match[r[:, None, None], x[:, :, None], y[:, None, :]]

    def ins(x):
        return insert[r[:, None], x]

    m_f, end = ph.fwd_exact_wave(emit(xb, yb), ins(xb), ins(yb), lx, ly,
                                 start, tv)
    m_b, corner, _ = ph.bwd_exact_wave(emit(xr, yr), ins(xr), ins(yr),
                                       start, tv)
    for k in range(2):
        cells = (slice(k, k + 1), slice(0, int(lx[k]) + 1),
                 slice(0, int(ly[k]) + 1))
        assert np.array_equal(m_f[cells].numpy(), jx[key + "fm"][cells])
        assert np.array_equal(m_b[cells].numpy(), jx[key + "rbm"][cells])
    assert np.array_equal(end.numpy(), jx[key + "fend"])
    assert np.array_equal(corner.numpy(), jx[key + "corner"])


def test_plain_sources_agree():
    """The letter source and its lattice give the two plain versions the
    same cells inside each pair, and the backward's far corner folds to
    the forward's total (-testfb)."""
    xb, yb, lx, ly, match, insert, _, _ = _small()
    pack = HMMParams.from_defaults().to_scores()
    from muscle_tpu_torch.ops.pairhmm_cuda import params_vec
    params = params_vec(pack, "cpu")
    src = pec.Letters(xb, yb, match, insert)
    lat = pec.Lattice(*pec._lattice(src))
    for fn in (pec.pairhmm_fwd_exact, pec.pairhmm_bwd_exact):
        a_m, a_end = fn(src, lx, ly, params)
        b_m, b_end = fn(lat, lx, ly, params)
        for k in range(2):
            assert torch.equal(a_m[k, :lx[k], :ly[k]], b_m[k, :lx[k], :ly[k]])
        assert torch.equal(a_end, b_end)
    start = pec.start_scores(params, 2)
    fwd = ph.total_prob(pec.pairhmm_fwd_exact(src, lx, ly, params)[1], start)
    bwd = ph.total_prob(pec.pairhmm_bwd_exact(src, lx, ly, params)[1], start)
    assert torch.allclose(fwd, bwd, rtol=1e-3)   # -testfb's limit


def test_wrapper_rejects_bad_inputs():
    xb, yb, lx, ly, match, insert, _, _ = _small()
    params = torch.zeros(16)
    with pytest.raises(ValueError):
        pec._check(pec.Letters(xb.long(), yb, match, insert), lx, ly, params)
    with pytest.raises(ValueError):
        pec._check(pec.Letters(xb, yb, match, insert), lx, ly,
                   torch.zeros(3, 16))
    assert pec._check(pec.Letters(xb, yb, match, insert), lx, ly,
                      params) == (2, 72, 72)
    assert pec.exact_geometry(72) == (3, 1)
    assert pec.exact_geometry(2100) == (4, 17)
