"""The long-pair router and align() through it, against muscle_tpu.

* pipeline/posteriors._long_pairs_sparse with its limits shrunk so that
  every route is taken (the kernel routes run their plain twins on CPU
  tensors), against the in-cap store and muscle_tpu's store;
* on the CPU every long pair takes the scan route, as in muscle_tpu;
* align() through the scan route, AFA text equal to muscle_tpu.align's,
  and at the package's own threshold.
The routes' modules against muscle_tpu: tests/test_torch_longpair.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, set by conftest)
import muscle_tpu
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.ops import pairhmm_long as j_long
from muscle_tpu.pipeline import posteriors as j_post
from muscle_tpu_torch import MultiSequence, Sequence, align
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm_long as t_long
from muscle_tpu_torch.pipeline import posteriors as t_post

AMINO = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def packs():
    jp = JHMMParams.from_defaults().to_scores()
    tp = score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)
    return jp, tp


def _family_codes(lens, l, seed):
    """Mutated copies of one random protein, encoded and padded to l."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, l)
    codes = np.full((len(lens), l), 20, np.int32)
    for i, n in enumerate(lens):
        c = base[:n].copy()
        mut = rng.random(n) < 0.2
        c[mut] = rng.integers(0, 20, mut.sum())
        codes[i, :n] = c
    return codes


def test_router_takes_every_route(packs, monkeypatch):
    """Limits shrunk (threshold 128, lane cap 128, stripes of 64) so that
    the pairs of one family take all four routes; the kernel routes run
    their twins on the CPU. The store matches the in-cap bucketed store
    and muscle_tpu's store on its CPU route."""
    jp, tp = packs
    lens = np.array([250, 120, 240, 100, 160], np.int32)
    l = 256
    codes = _family_codes(lens, l, 3)
    n = len(lens)
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    cpu = torch.device("cpu")
    monkeypatch.setattr(t_post, "default_backend", lambda device: "cuda")
    sv0, sc0, ea0, _ = t_post.all_pairs_posteriors_sparse(codes, lens, tp,
                                                          pairs, cpu)
    jv, jc, jea, _ = j_post.all_pairs_posteriors_sparse(codes, lens, jp,
                                                        pairs)

    monkeypatch.setattr(t_post, "LONG_PAIR_THRESHOLD", 128)
    monkeypatch.setattr(t_post, "_LONG_PALLAS_MAX_LY", 128)
    monkeypatch.setattr(t_post, "_LONG_PALLAS_CELL_BUDGET", 256 * 128)
    monkeypatch.setattr(t_post, "_STRIPE_W", 64)
    monkeypatch.setattr(t_post, "_STRIPED_CELL_BUDGET", 256 * 192)
    t_post.reset_routes()
    sv1, sc1, ea1, _ = t_post.all_pairs_posteriors_sparse(codes, lens, tp,
                                                          pairs, cpu)
    assert t_post.ROUTES == {"in_cap": 4, "transposed": 3, "striped": 2,
                             "scan": 1}
    sv1, sc1 = sv1.numpy(), sc1.numpy()
    for v0, c0, e0 in ((sv0.numpy(), sc0.numpy(), ea0),
                       (np.asarray(jv), np.asarray(jc), jea)):
        ok = (c0[:len(pairs)] >= 0) & (sc1[:len(pairs)] >= 0)
        dv = np.where(ok, v0[:len(pairs)] - sv1[:len(pairs)], 0.0)
        assert float(np.abs(dv).max()) < 2e-2
        assert float(np.abs(e0 - ea1).max()) < 2e-3
    assert not sv1[len(pairs):].any() and (sc1[len(pairs):] == -1).all()


def test_router_scans_on_the_cpu(packs, monkeypatch):
    """Without a card every long pair takes the scan, as the JAX
    package's CPU backend does."""
    _, tp = packs
    lens = np.array([150, 140], np.int32)
    codes = _family_codes(lens, 256, 4)
    monkeypatch.setattr(t_post, "LONG_PAIR_THRESHOLD", 128)
    t_post.reset_routes()
    sv, sc, ea, nnz = t_post.all_pairs_posteriors_sparse(
        codes, lens, tp, [(0, 1)], torch.device("cpu"))
    assert t_post.ROUTES == {"in_cap": 0, "transposed": 0, "striped": 0,
                             "scan": 1}
    vals, cols, ea1, _ = t_long.long_pair_posterior_sparse(
        codes[0][:150], codes[1][:140], tp, k=32, row_block=2048)
    assert np.array_equal(sv[0, :150].numpy(), vals)
    assert np.array_equal(sc[0, :150].numpy(), cols)
    assert ea[0] == np.float32(ea1) and 0 < nnz <= 32


# ---------------------------------------------------------------------------
# align() end to end
# ---------------------------------------------------------------------------

def test_align_long_route_equals_jax(monkeypatch):
    """n = 4, L 150-250, LONG_PAIR_THRESHOLD lowered to 128 and the dense
    branch off in both packages: every pair takes the scan route, the
    Gram consistency and the host refine follow."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 20, 250)
    lines = []
    for i, n in enumerate((160, 150, 160, 150)):
        c = base[:n].copy()
        mut = rng.random(n) < 0.25
        c[mut] = rng.integers(0, 20, mut.sum())
        lines.append(f">s{i}\n{''.join(AMINO[a] for a in c)}\n")
    text = "".join(lines)
    for mod in (t_post, j_post):
        monkeypatch.setattr(mod, "LONG_PAIR_THRESHOLD", 128)
        monkeypatch.setattr(mod, "SMALL_DENSE_NL", 512)
    calls = []
    real = j_long.long_pair_posterior_sparse

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(j_long, "long_pair_posterior_sparse", spy)
    t_post.reset_routes()
    ours = align(MultiSequence.from_fasta(text), refine_iters=4,
                 device="cpu")
    ref = muscle_tpu.align(muscle_tpu.MultiSequence.from_fasta(text),
                           refine_iters=4)
    assert t_post.ROUTES["scan"] == 6 and len(calls) == 6
    assert ours.to_fasta_text() == ref.to_fasta_text()


def test_align_takes_pads_beyond_the_threshold():
    """A family padded beyond 8192 (to 12288) runs through the scan route
    on the CPU at the package's own limits (n = 2: no consistency, no
    refine); its alignment keeps every residue."""
    rng = np.random.default_rng(12)
    seqs = MultiSequence([
        Sequence("a", "".join(AMINO[c] for c in rng.integers(0, 20, 40))),
        Sequence("b", "".join(AMINO[c] for c in rng.integers(0, 20, 8200)))])
    t_post.reset_routes()
    msa = align(seqs, device="cpu")
    assert t_post.ROUTES["scan"] == 1
    assert {s.label: s.text().replace("-", "") for s in msa} == \
        {s.label: s.text() for s in seqs}


def test_router_takes_every_route_with_x_after_y(packs, monkeypatch):
    """Pairs with x > y, as Super5's PairAligner hands them to the router
    (PProg, UCLUST), with the limits shrunk so that every route is taken
    (in this orientation the family's pairs of two long sides are
    256 x 192 twice, striped, and 256 x 256, scanned): the store holds
    each pair with x's positions as rows, as muscle_tpu's router gives it
    on the same pairs (its CPU route, the scan; run on one pair of each
    route, since it compiles its scan for every pair shape)."""
    jp, tp = packs
    lens = np.array([150, 120, 250, 100, 200], np.int32)
    codes = _family_codes(lens, 256, 3)
    n = len(lens)
    pairs = [(y, x) for x in range(n) for y in range(x + 1, n)]
    monkeypatch.setattr(t_post, "LONG_PAIR_THRESHOLD", 128)
    monkeypatch.setattr(t_post, "default_backend", lambda device: "cuda")
    monkeypatch.setattr(t_post, "_LONG_PALLAS_MAX_LY", 128)
    monkeypatch.setattr(t_post, "_LONG_PALLAS_CELL_BUDGET", 256 * 128)
    monkeypatch.setattr(t_post, "_STRIPE_W", 64)
    monkeypatch.setattr(t_post, "_STRIPED_CELL_BUDGET", 256 * 192)
    cpu = torch.device("cpu")
    t_post.reset_routes()
    sv, sc, ea, _ = t_post._long_pairs_sparse(codes, lens, tp, pairs, 32, cpu)
    assert t_post.ROUTES == {"in_cap": 4, "transposed": 3, "striped": 2,
                             "scan": 1}
    assert not sv[len(pairs):].any() and (sc[len(pairs):] == -1).all()
    sv, sc = sv.numpy(), sc.numpy()
    for i, (x, _) in enumerate(pairs):
        assert (sc[i, lens[x]:] == -1).all() and (sc[i, :lens[x], 0] >= 0).any()
    # one pair of each route: in-cap, transposed, striped, scan
    each = [(3, 1), (1, 0), (2, 0), (4, 2)]
    for route, pair in zip(("in_cap", "transposed", "striped", "scan"), each):
        t_post.reset_routes()
        t_post._long_pairs_sparse(codes, lens, tp, [pair], 32, cpu)
        assert t_post.ROUTES[route] == 1, (pair, t_post.ROUTES)
    monkeypatch.setattr(j_post, "LONG_PAIR_THRESHOLD", 128)
    jv, jc, jea, _ = j_post._long_pairs_sparse(codes, lens, jp, each, 32)
    rows = [pairs.index(p) for p in each]
    jv, jc = np.asarray(jv)[:4], np.asarray(jc)[:4]
    assert (sc[rows] == jc).mean() > 0.99
    ok = (jc >= 0) & (sc[rows] >= 0)
    assert float(np.abs(np.where(ok, jv - sv[rows], 0.0)).max()) < 2e-2
    assert float(np.abs(jea - ea[rows]).max()) < 2e-3
