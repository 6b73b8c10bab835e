"""Muscle-3D `-align` on `.mega` structure profiles: the port against
muscle_tpu on the CPU.

The reference's `.mega` inputs are not in the repository, so the sets
are synthetic (tests/mega_synth.py: 8 features, the reference files'
width), written in the reference's text format:

* io/mega.py: parse_mega / write_mega give JAX's arrays and text;
* ops/emissions.py: the emission lattice and insert scores equal
  JAX's bit for bit (both sum the rounded products feature by feature;
  XLA on the CPU does not contract them into fused multiply-adds here);
* ops/pairhmm.batch_posteriors_emissions (the CPU route) within 6e-8 of
  JAX's, as tests/test_torch_pairhmm.py holds the letter path;
* align(mega=, device="cpu") gives muscle_tpu.align(mega=)'s AFA text on
  the dense branch and on the sparse branch (SMALL_DENSE_NL shrunk on
  both sides), once with device refine forced;
* the CLI on a `.mega` file, by its header and by -mega.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import muscle_tpu
from mega_synth import mega_text
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.io import mega as j_mega
from muscle_tpu.ops import emissions as j_em
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.pipeline import posteriors as j_post
import muscle_tpu_torch
from muscle_tpu_torch import cli
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.io import mega as t_mega
from muscle_tpu_torch.ops import emissions as t_em
from muscle_tpu_torch.ops import pairhmm as t_pairhmm
from muscle_tpu_torch.pipeline import mpc as t_mpc
from muscle_tpu_torch.pipeline import posteriors as t_post


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU scan runs many small ops, which gain nothing from
    intra-op threads; one thread keeps it from crowding the other test
    workers on the CPU."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def text():
    return mega_text(8, 90, 128, 11)


def test_parse_and_write_match_jax(text, tmp_path):
    jm, tm = j_mega.parse_mega(text), t_mega.parse_mega(text)
    assert tm.feature_names == jm.feature_names == ["AA"] + [
        f"S{f}" for f in range(1, 8)]
    assert tm.alpha_sizes == jm.alpha_sizes
    assert tm.labels == jm.labels and tm.seqs == jm.seqs
    assert (tm.gap_open, tm.gap_ext) == (jm.gap_open, jm.gap_ext)
    assert np.array_equal(tm.weights, jm.weights)
    assert abs(float(tm.weights.sum()) - 1.0) < 1e-5
    for name in ("log_probs", "log_prob_mx", "log_odds_mx", "profiles"):
        for a, b in zip(getattr(tm, name), getattr(jm, name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    j_mega.write_mega(jm, str(tmp_path / "j.mega"))
    t_mega.write_mega(tm, str(tmp_path / "t.mega"))
    assert (tmp_path / "t.mega").read_text() == \
        (tmp_path / "j.mega").read_text()
    # a parse of the written file gives the same numbers again
    again = t_mega.parse_mega(str(tmp_path / "t.mega"))
    for a, b in zip(again.log_prob_mx, tm.log_prob_mx):
        assert np.array_equal(a, b)


def _pairs_batch(ms, pad):
    prof = j_em.pad_profiles(ms.profiles, pad)
    lens = np.array([p.shape[0] for p in ms.profiles], np.int32)
    xi = np.array([0, 0, 1, 2, 3, 4, 5, 6])
    yi = np.array([1, 7, 3, 4, 5, 6, 7, 2])
    return prof[xi], prof[yi], lens[xi], lens[yi]


def test_emissions_bit_identical(text):
    jm, tm = j_mega.parse_mega(text), t_mega.parse_mega(text)
    assert np.array_equal(t_em.pad_profiles(tm.profiles, 128),
                          j_em.pad_profiles(jm.profiles, 128))
    px, py, _, _ = _pairs_batch(jm, 128)
    w, lp, lpm = j_em.mega_feature_arrays(jm)
    tw, tlp, tlpm = t_em.mega_feature_arrays(tm)
    e_j = np.asarray(j_em.mega_emission_matrix(jnp.asarray(px),
                                               jnp.asarray(py), w, lpm))
    e_t = t_em.mega_emission_matrix(torch.as_tensor(px), torch.as_tensor(py),
                                    tw, tlpm).numpy()
    assert e_t.dtype == np.float32 and np.array_equal(e_t, e_j)
    for p in (px, py):
        i_j = np.asarray(j_em.mega_insert_scores(jnp.asarray(p), w, lp))
        i_t = t_em.mega_insert_scores(torch.as_tensor(p), tw, tlp).numpy()
        assert np.array_equal(i_t, i_j)


def test_batch_posteriors_emissions_matches_jax(text):
    """The scan route from the same lattices (JAX's builders, the
    per-pair roll-flipped profiles for e_rev, as its chunk function)."""
    jm = j_mega.parse_mega(text)
    px, py, lx, ly = _pairs_batch(jm, 128)
    w, lp, lpm = j_em.mega_feature_arrays(jm)

    def rev(p, n):
        return jax.vmap(lambda a, k: jnp.roll(jnp.flip(a, 0), k - 128,
                                              axis=0))(jnp.asarray(p),
                                                       jnp.asarray(n))
    pxr, pyr = rev(px, lx), rev(py, ly)
    args = [j_em.mega_emission_matrix(jnp.asarray(px), jnp.asarray(py), w,
                                      lpm),
            j_em.mega_emission_matrix(pxr, pyr, w, lpm),
            j_em.mega_insert_scores(jnp.asarray(px), w, lp),
            j_em.mega_insert_scores(jnp.asarray(py), w, lp),
            j_em.mega_insert_scores(pxr, w, lp),
            j_em.mega_insert_scores(pyr, w, lp)]
    jp = JHMMParams.from_defaults().to_scores()
    post_j, ea_j = j_pairhmm.batch_posteriors_emissions(
        *args, jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(jp.start),
        j_pairhmm._trans_vec(jp))
    tp = score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)
    start, tv = t_pairhmm.score_args(tp)[2:]
    post_t, ea_t = t_pairhmm.batch_posteriors_emissions(
        *(torch.as_tensor(np.array(a)) for a in args), torch.as_tensor(lx),
        torch.as_tensor(ly), start, tv)
    assert float(np.abs(post_t.numpy() - np.asarray(post_j)).max()) < 6e-8
    assert float(np.abs(ea_t.numpy() - np.asarray(ea_j)).max()) < 6e-8
    # the port's CPU chunk function builds the same inputs itself
    tm = t_mega.parse_mega(text)
    fn = t_post._make_mega_chunk_fn(tm, tp, torch.device("cpu"))
    post_f, ea_f = fn(*(torch.as_tensor(a) for a in (px, py, lx, ly)))
    assert torch.equal(post_f, post_t) and torch.equal(ea_f, ea_t)


def _seqs(ms, pkg):
    return pkg.MultiSequence([pkg.Sequence(lb, sq)
                              for lb, sq in zip(ms.labels, ms.seqs)])


@pytest.mark.parametrize("branch,refine_iters", [
    ("dense", 100), ("sparse", 100), ("sparse-device-refine", 30)])
def test_align_mega_equals_jax(text, monkeypatch, branch, refine_iters):
    """n = 8, L 90-128 (n * pad = 1024): the dense branch as it is; the
    sparse branch (bucketed mega store, Gram consistency) with
    SMALL_DENSE_NL shrunk to 256 in both packages; and the latter with
    device refine joins forced in both."""
    if branch != "dense":
        for mod in (t_post, j_post):
            monkeypatch.setattr(mod, "SMALL_DENSE_NL", 256)
    if branch == "sparse-device-refine":
        monkeypatch.setattr(t_mpc, "DEVICE_REFINE_N", 1)
        monkeypatch.setenv("MUSCLE_TPU_DEVICE_REFINE", "1")
    jm, tm = j_mega.parse_mega(text), t_mega.parse_mega(text)
    ours = muscle_tpu_torch.align(_seqs(tm, muscle_tpu_torch), mega=tm,
                                  refine_iters=refine_iters, device="cpu")
    ref = muscle_tpu.align(_seqs(jm, muscle_tpu), mega=jm,
                           refine_iters=refine_iters)
    assert ours.to_fasta_text() == ref.to_fasta_text()


def test_cli_reads_mega_by_header_and_by_flag(tmp_path):
    """-align on a .mega file (its header) and, with -mega, on one that
    starts with a blank line (no header at the start): both give
    align(mega=)'s alignment."""
    small = mega_text(4, 60, 90, 12)
    path = tmp_path / "in.mega"
    path.write_text(small)
    ms = t_mega.parse_mega(small)
    want = muscle_tpu_torch.align(_seqs(ms, muscle_tpu_torch), mega=ms,
                                  device="cpu").to_fasta_text()
    out = tmp_path / "out.afa"
    assert cli.main(["-align", str(path), "-output", str(out), "-device",
                     "cpu", "-quiet"]) == 0
    assert out.read_text() == want
    blank = tmp_path / "blank.mega"
    blank.write_text("\n" + small)
    out2 = tmp_path / "out2.afa"
    assert cli.main(["-align", str(blank), "-mega", "-output", str(out2),
                     "-device", "cpu", "-quiet"]) == 0
    assert out2.read_text() == want
