"""Host-side copies in muscle_tpu_torch against muscle_tpu.

The port keeps its own copies of the JAX package's numpy/Python modules
(it may import neither jax nor muscle_tpu). These tests hold each copy
to the original on the same inputs: encodings and the alphabet guess,
the HMM score tables (defaults and perturbed), the random streams, the
guide tree and join order, and sparsify. Two tests check the port's own
numerics helpers: the posterior's exp and the scoped TF32 switch of the
consistency product. The last test scans the port's sources for
forbidden imports.
"""

import ast
import os

import numpy as np
import pytest
import torch

import muscle_tpu.alphabet as j_alpha
import muscle_tpu.hmm.params as j_params
import muscle_tpu.ops.sparse as j_sparse
import muscle_tpu.sequence as j_seq
import muscle_tpu.tree.joinorder as j_join
import muscle_tpu.tree.upgma as j_upgma
import muscle_tpu.utils.rng as j_rng
import muscle_tpu_torch.alphabet as t_alpha
import muscle_tpu_torch.hmm.params as t_params
import muscle_tpu_torch.ops.sparse as t_sparse
import muscle_tpu_torch.sequence as t_seq
import muscle_tpu_torch.tree.joinorder as t_join
import muscle_tpu_torch.tree.upgma as t_upgma
import muscle_tpu_torch.utils.rng as t_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens")
NT = os.path.join(ROOT, "tests", "data", "nt")

INPUTS = ([(os.path.join(GOLDEN, f"BB1100{k}.seq.afa"), True)
           for k in (1, 2, 4, 5, 6, 7, 9)]
          + [(os.path.join(NT, f"nt{k}.fa"), False) for k in (1, 2, 3)])


@pytest.mark.parametrize("path,strip", INPUTS,
                         ids=[os.path.basename(p) for p, _ in INPUTS])
def test_encode_and_guess_match(path, strip):
    js = j_seq.MultiSequence.from_fasta(path, strip_gaps=strip)
    ts = t_seq.MultiSequence.from_fasta(path, strip_gaps=strip)
    assert js.labels() == ts.labels()
    jn = j_alpha.guess_is_nucleo(js, j_rng.MwcRng(1))
    tn = t_alpha.guess_is_nucleo(ts, t_rng.MwcRng(1))
    assert jn == tn
    alpha = j_alpha.ALPHA_NUCLEO if jn else j_alpha.ALPHA_AMINO
    for a, b in zip(js, ts):
        assert np.array_equal(j_alpha.encode(a.bytes_view(), alpha),
                              t_alpha.encode(b.bytes_view(), alpha))


def _packs(nucleo, seed):
    jh = j_params.HMMParams.from_defaults(nucleo=nucleo)
    th = t_params.HMMParams.from_defaults(nucleo=nucleo)
    if seed:
        jh.perturb(seed)
        th.perturb(seed)
    return jh.to_scores(), th.to_scores()


@pytest.mark.parametrize("nucleo,seed", [(False, 0), (True, 0),
                                         (False, 7), (True, 3)])
def test_score_tables_equal(nucleo, seed):
    jp, tp = _packs(nucleo, seed)
    for f in ("start", "match", "insert"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    for f in ("tMM", "tMI", "tMJ", "tII", "tIM", "tJJ", "tJM", "alpha_size"):
        assert getattr(jp, f) == getattr(tp, f), f


def test_score_pack_from_numpy_roundtrip():
    jp, _ = _packs(False, 5)
    trans7 = [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM]
    tp = t_params.score_pack_from_numpy(jp.start, trans7, jp.match,
                                        jp.insert)
    assert np.array_equal(tp.match, jp.match)
    assert np.array_equal(tp.insert, jp.insert)
    assert np.array_equal(tp.start, jp.start)
    assert tp.alpha_size == jp.alpha_size and tp.tJM == jp.tJM
    with pytest.raises(ValueError):
        t_params.score_pack_from_numpy(jp.start, trans7, jp.match[:3],
                                       jp.insert)


def test_rng_streams_equal():
    jm, tm = j_rng.MwcRng(12345), t_rng.MwcRng(12345)
    assert [jm.randu32() for _ in range(2000)] == \
        [tm.randu32() for _ in range(2000)]
    jg, tg = j_rng.GlibcRand(1), t_rng.GlibcRand(1)
    assert [jg.rand() for _ in range(2000)] == [tg.rand() for _ in range(2000)]
    items_j, items_t = list(range(50)), list(range(50))
    j_rng.MwcRng(9).shuffle(items_j)
    t_rng.MwcRng(9).shuffle(items_t)
    assert items_j == items_t


@pytest.mark.parametrize("n,seed", [(7, 0), (23, 1)])
def test_upgma5_and_join_order_equal(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)).astype(np.float32)
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    labels = [f"s{i}" for i in range(n)]
    jt = j_upgma.upgma5(labels, j_upgma.fix_ea_distmx(d),
                        j_upgma.LINKAGE_BIASED)
    tt = t_upgma.upgma5(labels, t_upgma.fix_ea_distmx(d),
                        t_upgma.LINKAGE_BIASED)
    assert jt.to_newick() == tt.to_newick()
    l2i = {lb: i for i, lb in enumerate(labels)}
    assert j_join.guide_tree_join_order(jt, l2i) == \
        t_join.guide_tree_join_order(tt, l2i)


def test_sparsify_matches_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    post = rng.random((3, 40, 56)).astype(np.float32) ** 6
    post[post < 0.01] = 0.0
    post[0, 5, :] = 0.25      # ties: the lower column comes first
    jv, jc, jn = j_sparse.sparsify(jnp.asarray(post), 16)
    tv, tc, tn = t_sparse.sparsify(torch.from_numpy(post), 16)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert int(jn) == int(tn)
    sv, sc = t_sparse.sparsify_np(post[1], 16)
    jsv, jsc = j_sparse.sparsify_np(post[1], 16)
    assert np.array_equal(sv, jsv) and np.array_equal(sc, jsc)
    assert np.array_equal(sv, tv[1].numpy())
    # at full width the round trip is exact
    fv, fc = t_sparse.sparsify_np(post[2], 56)
    assert np.array_equal(t_sparse.densify_np(fv, fc, 56), post[2])


def test_exp_f32_within_one_ulp_on_any_thread_layout():
    """The CPU scan's posterior exp: within 1 ulp of the f64 exp, and
    the same bits on one thread, on torch's pool and at a chunk offset."""
    from muscle_tpu_torch.ops.logspace import exp_f32
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.concatenate(
        [np.linspace(-87.0, 0.0, 200_001), -6.0 * rng.random(100_000)]
    ).astype(np.float32))
    got = exp_f32(x)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = exp_f32(x)
    finally:
        torch.set_num_threads(n)
    ref = np.exp(x.numpy().astype(np.float64))
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(got.numpy() - ref) / ulp) <= 1.0
    assert torch.equal(got, one)
    assert torch.equal(exp_f32(x[7:].clone()), got[7:])


def test_consistency_product_runs_without_tf32(monkeypatch):
    """TF32 is off during the block product and the caller's flags are
    back afterwards."""
    from muscle_tpu_torch.ops import consistency
    seen = []
    matmul = torch.matmul

    def spy(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return matmul(a, b)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    post = torch.zeros(3, 3, 4, 4)
    post[0, 1] = post[1, 0] = 0.5
    out = consistency.consistency_iter(post, consistency.sparsity_mask(post),
                                       3)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    # (2 P_01 + P_02 P_21) / 3 with P_02 = 0: 2 * 0.5 / 3 on the pattern
    assert torch.allclose(out[0, 1], torch.full((4, 4), 1.0 / 3.0))


def _port_sources():
    pkg = os.path.join(ROOT, "muscle_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_muscle_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "muscle_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad
