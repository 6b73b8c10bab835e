"""The plain versions of the Muscle-3D kernels against the Pallas kernels.

The port's emissions path (muscle_tpu_torch.ops.pairhmm_emis_cuda) runs
four CUDA kernels; on CPU tensors each wrapper runs its plain version,
the torch transcription of the kernel's own association. Here those
plain versions meet the Pallas kernels they replace, run in interpret
mode on the CPU, at the kernel gate of tests/test_pallas_fused.py:62-69
(posterior within 2e-3 ignoring cells that flip at the 0.01 threshold,
EA within 2e-3):

* kernels 1E and 2E (the fused route) against `_emissions_path_fused`;
* kernel 4 against `mea_scores_pallas`;
* kernel 3 against `_bwd_kernel`, launched by a pallas_call with
  `_bwd_pallas`'s block specs and interpret=True (`_bwd_pallas` itself
  takes no interpret flag);
* the whole legacy route (1E, 3, finish_posteriors, 4) against JAX's
  scan `batch_posteriors_emissions`;
* the equality kernel 3 relies on: JAX's roll-flipped lattice e_rev is
  e read through reversed indices, bit for bit;
* the row dependences by which chip_smoke.py holds full-length launches
  of 1E and 3 on a slice of rows.
Inputs: 8 pairs of a synthetic 8-feature `.mega` set (tests/mega_synth.py),
padded to 128. The kernels against these plain versions on the card:
tests/test_torch_cuda.py and chip_smoke.py.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from mega_synth import mega_text
from muscle_tpu.hmm.params import HMMParams as JHMMParams
from muscle_tpu.io.mega import parse_mega as j_parse
from muscle_tpu.ops import emissions as j_em
from muscle_tpu.ops import pairhmm as j_pairhmm
from muscle_tpu.ops import pairhmm_pallas as j_pallas
from muscle_tpu_torch.hmm.params import score_pack_from_numpy
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda
from muscle_tpu_torch.ops import pairhmm_emis_cuda as t_emis

PAD = 128
XI = np.array([0, 0, 1, 2, 3, 4, 5, 6])
YI = np.array([1, 2, 3, 4, 5, 6, 7, 3])


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
def case():
    """Emission lattices, insert scores and lengths of 8 mega pairs
    (JAX's builders; tests/test_torch_mega.py holds the port's builders
    to them), the JAX score pack and the same tables in the port."""
    ms = j_parse(mega_text(8, 60, 120, 5))
    prof = j_em.pad_profiles(ms.profiles, PAD)
    lens = np.array([p.shape[0] for p in ms.profiles], np.int32)
    w, lp, lpm = j_em.mega_feature_arrays(ms)
    px, py = jnp.asarray(prof[XI]), jnp.asarray(prof[YI])
    lx, ly = lens[XI], lens[YI]

    def roll_flip(p, n):
        return jax.vmap(lambda a, k: jnp.roll(jnp.flip(a, 0), k - PAD,
                                              axis=0))(p, jnp.asarray(n))
    pxr, pyr = roll_flip(px, lx), roll_flip(py, ly)
    jp = JHMMParams.from_defaults().to_scores()
    tp = score_pack_from_numpy(
        jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ, jp.tJM],
        jp.match, jp.insert)
    arr = {k: np.array(v) for k, v in dict(
        e=j_em.mega_emission_matrix(px, py, w, lpm),
        e_rev=j_em.mega_emission_matrix(pxr, pyr, w, lpm),
        ins_x=j_em.mega_insert_scores(px, w, lp),
        ins_y=j_em.mega_insert_scores(py, w, lp),
        ins_xr=j_em.mega_insert_scores(pxr, w, lp),
        ins_yr=j_em.mega_insert_scores(pyr, w, lp)).items()}
    return arr, lx, ly, jp, tp


def _t(*arrs):
    return tuple(torch.as_tensor(np.array(a)) for a in arrs)


def _args(case):
    arr, lx, ly, _, tp = case
    return _t(arr["e"], arr["ins_x"], arr["ins_y"], lx, ly) + (
        t_cuda.params_vec(tp, "cpu"),)


def _jax_params(jp, b):
    start = jnp.asarray(jp.start)
    tv = j_pairhmm._trans_vec(jp)
    return start, tv, j_pallas._params_rows(start, tv, b)


def _assert_gate(post_ref, ea_ref, post, ea):
    post_ref, post = np.asarray(post_ref), np.asarray(post)
    d = np.abs(post_ref - post)
    flip = ((post_ref == 0) | (post == 0)) & \
           (np.maximum(post_ref, post) <= 0.0102)
    dpost = float(np.max(np.where(flip, 0.0, d)))
    dea = float(np.max(np.abs(np.asarray(ea_ref) - np.asarray(ea))))
    assert dpost < 2e-3, dpost
    assert dea < 2e-3, dea


def test_fused_route_matches_pallas_interpret(case):
    """Kernels 1E, the total-probability fold and 2E against the Pallas
    `_emissions_path_fused` (kk=None, flip_e=True) in interpret mode."""
    arr, lx, ly, jp, tp = case
    start, _, params = _jax_params(jp, 8)
    bstart = jnp.broadcast_to(jnp.stack([start[0], start[1], start[1],
                                         start[3], start[3]]), (8, 5))
    post_p, ea_p = j_pallas._emissions_path_fused(
        jnp.asarray(arr["e"]), jnp.asarray(arr["ins_x"]),
        jnp.asarray(arr["ins_y"]), jnp.asarray(lx), jnp.asarray(ly), params,
        bstart, 8, j_pallas.SCAN_IMPL, True, True)
    post, ea = t_emis.emissions_path_fused(*_args(case))
    _assert_gate(post_p, ea_p, post, ea)
    # the entry point on CPU tensors at Ly <= FUSED_MAX_LY runs exactly this
    t_emis.reset_routes()
    e, ins_x, ins_y, lxt, lyt, _ = _args(case)
    post_w, ea_w = t_emis.batch_posteriors_emissions_cuda(e, ins_x, ins_y,
                                                          lxt, lyt, tp)
    assert t_emis.ROUTES == {"fused": 1, "legacy": 0}
    assert torch.equal(post_w, post) and torch.equal(ea_w, ea)


def test_mea_plain_matches_pallas_interpret(case):
    """Kernel 4's plain version against `mea_scores_pallas` (interpret)
    on the fused route's posteriors: max and add only, so equal."""
    post, _ = t_emis.emissions_path_fused(*_args(case))
    got = t_emis.mea_scores_plain(post)
    want = j_pallas.mea_scores_pallas(
        jnp.asarray(post.numpy().transpose(1, 0, 2)), 8, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(t_emis.mea_scores(post, *_args(case)[3:5]), got)


def _bwd_pallas_interpret(e_rev_t, insx_rev_t, insy_rev, params, tile_p,
                          impl):
    """`_bwd_pallas`'s pallas_call of `_bwd_kernel`, with interpret=True."""
    lx, b, ly = e_rev_t.shape
    return pl.pallas_call(
        partial(j_pallas._bwd_kernel, None, impl),
        grid=(b // tile_p, lx),
        in_specs=[
            pl.BlockSpec((tile_p, 16), lambda t, i: (t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, tile_p, ly),
                         lambda t, i: (jnp.maximum(i - 1, 0), t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, tile_p, 1),
                         lambda t, i: (jnp.maximum(i - 1, 0), t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tile_p, ly), lambda t, i: (t, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, tile_p, ly), lambda t, i: (i, t, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((lx, b, ly), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tile_p, ly), jnp.float32)] * 5
        + [pltpu.VMEM((tile_p, 128), jnp.float32)],
        interpret=True,
    )(params, e_rev_t, insx_rev_t, insy_rev)


def test_bwd_plain_matches_pallas_bwd_kernel(case):
    """Kernel 3's plain version (e read through reversed indices) against
    the Pallas `_bwd_kernel` fed JAX's roll-flipped e_rev, on every cell
    that _finish_posteriors reads (rows u < lx, lanes v < ly); rows past
    lx are zero in the port."""
    arr, lx, ly, jp, _ = case
    _, _, params = _jax_params(jp, 8)
    rb_p = np.asarray(_bwd_pallas_interpret(
        jnp.asarray(arr["e_rev"].transpose(1, 0, 2)),
        jnp.asarray(arr["ins_xr"].T[:, :, None]), jnp.asarray(arr["ins_yr"]),
        params, 8, j_pallas.SCAN_IMPL)).transpose(1, 0, 2)
    rb = t_emis.pairhmm_bwd(*_args(case)).numpy()
    for k in range(8):
        want, got = rb_p[k, :lx[k], :ly[k]], rb[k, :lx[k], :ly[k]]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert not rb[k, lx[k]:].any()


def test_legacy_route_matches_jax_scan(case):
    """1E, 3, finish_posteriors, 4 against JAX's scan
    `batch_posteriors_emissions` (its CPU route) on the same lattices,
    and against the fused route."""
    arr, lx, ly, jp, tp = case
    start, tv, _ = _jax_params(jp, 8)
    post_s, ea_s = j_pairhmm.batch_posteriors_emissions(
        *(jnp.asarray(arr[k]) for k in ("e", "e_rev", "ins_x", "ins_y",
                                        "ins_xr", "ins_yr")),
        jnp.asarray(lx), jnp.asarray(ly), start, tv)
    post, ea = t_emis.emissions_path_legacy(*_args(case))
    _assert_gate(post_s, ea_s, post, ea)
    _assert_gate(*t_emis.emissions_path_fused(*_args(case)), post, ea)


def test_e_rev_is_e_read_reversed(case):
    """JAX's e_rev (emissions of the per-pair roll-flipped profiles) is
    e[b, lx-1-i, ly-1-j] on every cell i < lx, j < ly, bit for bit, and
    its reversed insert scores likewise: the same table entries summed
    over the features in the same order. Kernel 3 relies on it."""
    arr, lx, ly, _, _ = case
    for k in range(8):
        a, b = lx[k], ly[k]
        assert np.array_equal(arr["e_rev"][k, :a, :b],
                              arr["e"][k, :a, :b][::-1, ::-1])
        assert np.array_equal(arr["ins_xr"][k, :a], arr["ins_x"][k, :a][::-1])
        assert np.array_equal(arr["ins_yr"][k, :b], arr["ins_y"][k, :b][::-1])
    e, ins_x, ins_y, lxt, lyt, _ = _args(case)
    for k in range(8):
        assert torch.equal(t_emis.reversed_lanes(ins_y, lyt)[k, :ly[k]],
                           torch.as_tensor(arr["ins_yr"][k, :ly[k]]))


def test_first_and_last_rows_depend_on_their_slice_only(case):
    """The forward's rows i < r read x positions 0..r-1 only, and the
    legacy backward's rows u < r x positions lx-r..lx-1 only (row u reads
    lx-u); its rows u >= lx are zero. So a launch at full length is held
    to the plain versions on r rows of each pair (chip_smoke.py's
    hold_fwd / hold_bwd at mega-long's 12288 lanes)."""
    r = 32
    e, ins_x, ins_y, lxt, lyt, params = _args(case)
    assert int(lxt.min()) > r
    fm, _ = t_emis.fwd_emis_plain(e, ins_x, ins_y, lxt, lyt, params)
    rows = torch.full_like(lxt, r)
    head, _ = t_emis.fwd_emis_plain(e[:, :r].contiguous(),
                                    ins_x[:, :r].contiguous(), ins_y, rows,
                                    lyt, params)
    assert torch.equal(fm[:, :r], head)
    rb = t_emis.bwd_plain(e, ins_x, ins_y, lxt, lyt, params)
    ar = torch.arange(e.shape[0])[:, None]
    idx = lxt.long()[:, None] - r + torch.arange(r)[None, :]
    tail = t_emis.bwd_plain(e[ar, idx].contiguous(),
                            ins_x[ar, idx].contiguous(), ins_y, rows, lyt,
                            params)
    assert torch.equal(rb[:, :r], tail)
    for k, lx in enumerate(lxt.tolist()):
        assert not rb[k, lx:].any()


def test_lattice_plain_versions_repeat_the_letter_twins():
    """Fed the letter lattice match[x_i, y_j] with insert[x_i] and
    insert[y_j], the plain versions of 1E and 2E give kernels A and B's
    plain twins bit for bit (on the card: 1E = A and 2E = B)."""
    rng = np.random.default_rng(9)
    b, width = 4, 128
    lx = np.array([128, 70, 100, 33], np.int32)
    ly = np.array([128, 90, 41, 120], np.int32)
    xb = np.full((b, width), 20, np.int32)
    yb = np.full((b, width), 20, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, 21, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    match, insert, params = t_cuda.tables(
        score_pack_from_numpy(*_pack_fields()), "cpu")
    x, y, lxt, lyt = _t(xb, yb, lx, ly)
    fm, fend = t_cuda.fwd_plain(x, y, lxt, lyt, match, insert, params)
    tot = t_cuda._total_prob(fend, params)
    post, mea = t_cuda.bwd_post_plain(x, y, lxt, lyt, match, insert, params,
                                      tot, fm)
    e = match[x.long()[:, :, None], y.long()[:, None, :]]
    ins_x, ins_y = insert[x.long()], insert[y.long()]
    fm2, fend2 = t_emis.pairhmm_fwd_emis(e, ins_x, ins_y, lxt, lyt, params)
    post2, mea2 = t_emis.pairhmm_bwd_post_emis(e, ins_x, ins_y, lxt, lyt,
                                               params, tot, fm)
    assert torch.equal(fm, fm2) and torch.equal(fend, fend2)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)


def _pack_fields():
    jp = JHMMParams.from_defaults().to_scores()
    return (jp.start, [jp.tMM, jp.tMI, jp.tMJ, jp.tII, jp.tIM, jp.tJJ,
                       jp.tJM], jp.match, jp.insert)


def test_entry_point_routes_and_limits(case, monkeypatch):
    """The legacy route beyond FUSED_MAX_LY (shrunk here) gives the
    legacy composition; pads beyond MAX_LY are not ported yet."""
    _, _, _, _, tp = case
    e, ins_x, ins_y, lxt, lyt, params = _args(case)
    monkeypatch.setattr(t_emis, "FUSED_MAX_LY", 64)
    t_emis.reset_routes()
    post, ea = t_emis.batch_posteriors_emissions_cuda(e, ins_x, ins_y, lxt,
                                                      lyt, tp)
    assert t_emis.ROUTES == {"fused": 0, "legacy": 1}
    want = t_emis.emissions_path_legacy(e, ins_x, ins_y, lxt, lyt, params)
    assert torch.equal(post, want[0]) and torch.equal(ea, want[1])
    wide = torch.zeros((1, 128, t_emis.MAX_LY + 128))
    with pytest.raises(NotImplementedError, match="queue 1, item 4$"):
        t_emis.batch_posteriors_emissions_cuda(
            wide, torch.zeros((1, 128)), torch.zeros((1, wide.shape[2])),
            lxt[:1], lyt[:1], tp)
