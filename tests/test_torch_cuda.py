"""The CUDA kernels of muscle_tpu_torch on the card.

The tests marked `cuda` need a CUDA device and nvcc; they skip
elsewhere. This file imports neither jax nor muscle_tpu, so it also
runs where JAX is not installed:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda.py

(MUSCLE_TPU_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
"""

import os

import numpy as np
import pytest
import torch

from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.ops import pairhmm_cuda as pc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


def _real(t, lx, ly):
    """t (B, Lx, Ly) with the cells outside each pair's (lx, ly) zeroed:
    the forward kernels (A, 1M, 1E) leave rows past lx and the 64-lane
    segments past column ly unwritten, and every reader masks them."""
    r = torch.arange(t.shape[1], device=t.device)[None, :, None]
    c = torch.arange(t.shape[2], device=t.device)[None, None, :]
    return t.where((r < lx[:, None, None]) & (c < ly[:, None, None]), 0.0)


def _batch(b, lmax, width, seed, nucleo):
    nletters = 4 if nucleo else 20
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    ly = rng.integers(max(8, lmax // 3), lmax + 1, size=b).astype(np.int32)
    lx[0] = ly[0] = lmax
    xb = np.full((b, width), nletters, np.int32)
    yb = np.full((b, width), nletters, np.int32)
    for i in range(b):
        xb[i, :lx[i]] = rng.integers(0, nletters + 1, size=lx[i])
        yb[i, :ly[i]] = rng.integers(0, nletters + 1, size=ly[i])
    return xb, yb, lx, ly


def test_kernel_build_flags(monkeypatch):
    """sm_90a, IEEE arithmetic (no fast math, no FMA contraction), a
    plain C interface; every spec keyed on its header too."""
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    for spec in pc.kernel_specs():
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert not any("fast_math" in f for f in spec.flags)
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        assert any(d.endswith("pairhmm_common.cuh") for d in spec.deps)


def test_cpu_tensors_run_the_twins_and_count_nothing():
    xb, yb, lx, ly = _batch(2, 60, 128, 0, False)
    pack = HMMParams.from_defaults().to_scores()
    before = dict(pc.LAUNCHES)
    post, ea = pc.batch_posteriors_cuda(*(torch.from_numpy(a) for a in
                                          (xb, yb, lx, ly)), pack)
    assert pc.LAUNCHES == before
    assert post.shape == (2, 128, 128) and ea.shape == (2,)
    assert bool(torch.isfinite(ea).all()) and bool((ea > 0).all())
    post0, ea0 = pc.batch_posteriors_cuda(*(torch.from_numpy(a) for a in
                                            (xb, yb, lx, ly)), pack,
                                          with_mea=False)
    assert torch.equal(post0, post) and not ea0.any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lmax,width,seed,nucleo", [
    (16, 300, 384, 5, False),
    (8, 1000, 1024, 6, True),
    (4, 2500, 2560, 7, False),
], ids=["amino-384", "nt-1024", "amino-2560"])
def test_kernels_match_twins(cuda_device, b, lmax, width, seed, nucleo):
    xb, yb, lx, ly = _batch(b, lmax, width, seed, nucleo)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(
        HMMParams.from_defaults(nucleo=nucleo).to_scores(), cuda_device)
    launches = dict(pc.LAUNCHES)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, match, insert, params)
    assert float((_real(fm, lxt, lyt) - _real(fm2, lxt, lyt)).abs().max()) \
        < 1e-3
    assert float((fend - fend2).abs().max()) < 1e-3
    tot = pc._total_prob(fend, params)
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    torch.cuda.synchronize()
    d = (post - post2).abs()
    flip = ((post == 0) | (post2 == 0)) & \
        (torch.maximum(post, post2) <= 0.0102)
    assert float(d.where(~flip, 0.0).max()) < 2e-3
    n = torch.minimum(lxt, lyt).float()
    assert float((mea / n - mea2 / n).abs().max()) < 2e-3
    assert pc.LAUNCHES["pairhmm_fwd"] == launches["pairhmm_fwd"] + 1
    assert pc.LAUNCHES["pairhmm_bwd_post"] == \
        launches["pairhmm_bwd_post"] + 1
    post0, _ = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                   tot, fm, with_mea=False)
    assert torch.equal(post0, post)


@pytest.mark.cuda
def test_wrapper_raises_on_unsupported_width(cuda_device):
    xb, yb, lx, ly = _batch(2, 60, 100, 0, False)
    with pytest.raises(ValueError):
        pc.batch_posteriors_cuda(
            *(torch.from_numpy(a).to(cuda_device) for a in (xb, yb, lx, ly)),
            HMMParams.from_defaults().to_scores())


@pytest.mark.cuda
def test_align_on_card_matches_golden(cuda_device):
    from muscle_tpu_torch import MultiSequence, align
    path = os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa")
    msa = align(MultiSequence.from_fasta(path, strip_gaps=True),
                device=cuda_device)
    gold = MultiSequence.from_fasta(path)
    assert {s.label: s.text() for s in msa} == \
        {s.label: s.text() for s in gold}


# ---------------------------------------------------------------------------
# kernels 7-8 and the MEA direction DP (ops/densify_cuda.py,
# ops/devjoin_cuda.py)
# ---------------------------------------------------------------------------

def _store(rng, p1, l, k, max_nnz=6):
    """(P1, l, k) store with 1..max_nnz unique columns per row (every
    slot where max_nnz >= k), valid slots first; the last row is the
    empty dump slot."""
    cols = np.argsort(rng.random((p1, l, l)), axis=-1)[..., :k].astype(
        np.int32)
    nnz = (np.full((p1, l, 1), k) if max_nnz >= k else
           rng.integers(1, max_nnz + 1, size=(p1, l, 1)))
    valid = np.arange(k) < nnz
    valid[-1] = False
    vals = np.where(valid, rng.random((p1, l, k)) * 0.9 + 0.02, 0.0)
    return vals.astype(np.float32), np.where(valid, cols, -1).astype(np.int32)


def test_new_kernel_build_flags(monkeypatch):
    from muscle_tpu_torch.ops import densify_cuda, devjoin_cuda
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    specs = densify_cuda.kernel_specs() + devjoin_cuda.kernel_specs()
    assert [s.name for s in specs] == ["densify", "densify_reduce",
                                       "densify_reduce_list", "mea_dirs"]
    for spec in specs:
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        # kernels 7 and 7L share one body: an edit to it rebuilds both
        assert (any(d.endswith("csrc/densify_reduce.cuh") for d in spec.deps)
                == spec.name.startswith("densify_reduce"))


def test_new_kernels_on_cpu_run_plain_versions_and_count_nothing():
    from muscle_tpu_torch.ops import densify_cuda as dc
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    rng = np.random.default_rng(1)
    vals, cols = _store(rng, 7, 16, 8)
    before = (dict(dc.LAUNCHES), dict(djc.LAUNCHES))
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    pids = torch.tensor([[0, 1, 6], [2, 6, 3]], dtype=torch.int32)
    flags = torch.tensor([[0, 1, 2], [1, 0, 0]], dtype=torch.int32)
    panel = dc.densify_panel(v, c, pids, flags, torch.bfloat16)
    assert panel.shape == (32, 48) and panel.dtype == torch.bfloat16
    bank = torch.arange(16, dtype=torch.int32).repeat(3, 1)
    f = djc.densify_reduce(v, c, 8, pids[:, :3].contiguous(), bank, 6, 20)
    assert f.shape == (2, 16, 20)
    packed, scores = djc.mea_dirs(torch.rand(5, 40))
    assert packed.shape == (5, 3) and scores.shape == (5,)
    f = djc.densify_reduce_list(v, c, 8, torch.tensor([0, 2, 3], dtype=torch.int32),
                                torch.tensor([0, 6, 3], dtype=torch.int32),
                                torch.tensor([1, 0, 2], dtype=torch.int32),
                                bank, 6, 20)
    assert f.shape == (2, 16, 20)
    assert (dict(dc.LAUNCHES), dict(djc.LAUNCHES)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_densify_kernel_matches_plain(cuda_device, dtype):
    from muscle_tpu_torch.ops import consistency as cons
    from muscle_tpu_torch.ops import densify_cuda as dc
    rng = np.random.default_rng(2)
    n, l, k, blk = 13, 128, 16, 4
    p1 = n * (n - 1) // 2 + 2
    vals, cols = _store(rng, p1, l, k)
    v, c = (torch.from_numpy(a).to(cuda_device) for a in (vals, cols))
    pid, flag = cons._block_maps(n, 20, p1 - 1)
    before = dc.LAUNCHES["densify"]
    for zi in range(-(-n // blk)):
        zs = slice(zi * blk, (zi + 1) * blk)
        p = torch.from_numpy(pid[zs]).to(cuda_device)
        f = torch.from_numpy(flag[zs]).to(cuda_device)
        got = dc.densify_panel(v, c, p, f, dtype)
        want = dc.densify_panel_plain(v, c, p, f, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert dc.LAUNCHES["densify"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "l,cc,k,k2,n_c,nnz",
    [(256, 300, 16, 8, 11, 6), (128, 13000, 16, 8, 11, 6),
     (128, 500, 32, 32, 11, 32), (384, 2600, 32, 32, 40, 8),
     (512, 768, 32, 24, 100, 8)],
    ids=["one-column-tile", "column-tiles", "k2-32-full-rows", "cc-2600",
         "l512-nc100"])
def test_densify_reduce_kernel_matches_plain(cuda_device, l, cc, k, k2, n_c,
                                            nnz):
    """Kernel 7 against its plain version, bit for bit: dump pairs, an
    all-dump row-owner, rows with every slot valid (nnz = K), column
    tiles, synthetic-1000's widest cc and the n = 200 half's L and n_c."""
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    rng = np.random.default_rng(3)
    n_r, p1 = 9, 120
    vals, cols = _store(rng, p1, l, k, max_nnz=nnz)
    pid = rng.integers(0, p1 - 1, size=(n_r, n_c)).astype(np.int32)
    pid[rng.random((n_r, n_c)) < 0.5] = p1 - 1
    pid[2] = p1 - 1
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n_c)]).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (vals, cols, pid, bank)]
    before = djc.LAUNCHES["densify_reduce"]
    got = djc.densify_reduce(args[0], args[1], k2, args[2], args[3], p1 - 1,
                             cc)
    want = djc.densify_reduce_plain(args[0], args[1], k2, args[2], args[3],
                                    p1 - 1, cc)
    torch.cuda.synchronize()
    assert djc.LAUNCHES["densify_reduce"] == before + 1
    assert torch.equal(got, want)
    assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "l,cc,k,k2,nnz",
    [(384, 600, 16, 8, 6), (128, 13000, 16, 8, 6), (128, 500, 32, 32, 32),
     (384, 2600, 32, 32, 8)],
    ids=["one-column-tile", "column-tiles", "k2-32-full-rows", "cc-2600"])
def test_densify_reduce_list_kernel_matches_plain(cuda_device, l, cc, k, k2,
                                                 nnz):
    """Kernel 7L against its plain version, bit for bit: owners with no
    entry, dump and out-of-range entries, full rows, and (at cc = 13000)
    a boundary between column tiles."""
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    rng = np.random.default_rng(5)
    n_s, n2, p1, n_e = 12, 7, 90, 200
    vals, cols = _store(rng, p1, l, k, max_nnz=nnz)
    owner = np.sort(rng.integers(0, n_s, n_e))
    owner[owner == 3] = 4
    pid = rng.integers(0, p1 - 1, n_e).astype(np.int32)
    pid[rng.random(n_e) < 0.1] = p1 - 1
    pid[5] = p1 + 3
    co = rng.integers(0, n2, n_e).astype(np.int32)
    row_ptr = np.zeros(n_s + 1, np.int32)
    np.cumsum(np.bincount(owner, minlength=n_s), out=row_ptr[1:])
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n2)]).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (vals, cols, row_ptr, pid, co, bank)]
    before = djc.LAUNCHES["densify_reduce_list"]
    got = djc.densify_reduce_list(args[0], args[1], k2, *args[2:], p1 - 1, cc)
    want = djc.densify_reduce_list_plain(args[0], args[1], k2, *args[2:],
                                         p1 - 1, cc)
    torch.cuda.synchronize()
    assert djc.LAUNCHES["densify_reduce_list"] == before + 1
    assert torch.equal(got, want)
    assert not got[3].any()


def _super5_set(seed=5):
    """3 families x 8 proteins of 60-90 aa, 2 duplicates and 3
    single-substitution near-duplicates (tests/test_torch_pprog.py)."""
    from muscle_tpu_torch import MultiSequence, Sequence
    aas = "ARNDCQEGHILKMFPSTWYV"
    rng = np.random.default_rng(seed)
    rows = []
    for f in range(3):
        base = rng.integers(0, 20, size=90)
        for i in range(8):
            ln = int(rng.integers(60, 91))
            mut = base[:ln].copy()
            pos = rng.integers(0, ln, size=int(rng.integers(ln // 10,
                                                            ln // 3)))
            mut[pos] = rng.integers(0, 20, size=len(pos))
            rows.append((f"f{f}s{i}", "".join(aas[c] for c in mut)))
    for d in range(2):
        rows.append((f"dup{d}", rows[3 * d + 1][1]))
    for d in range(3):
        s = rows[5 * d + 2][1]
        p = int(rng.integers(0, len(s)))
        rows.append((f"near{d}", s[:p] + aas[(aas.index(s[p]) + 1) % 20]
                     + s[p + 1:]))
    return MultiSequence([Sequence(lb, t) for lb, t in rows])


@pytest.mark.cuda
@pytest.mark.parametrize("joins", ["host", "device"])
def test_super5_on_card_matches_cpu(cuda_device, joins):
    """super5 of the small synthetic set on the card gives the CPU's
    alignment, with the default joins and with every PProg and refine
    join forced to the device (kernel 7L, kernel 7, mea_dirs)."""
    from muscle_tpu_torch import super5
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.pipeline import mpc, pprog
    seqs = _super5_set()
    saved = (pprog.DEVICE_JOIN_N, mpc.DEVICE_REFINE_N)
    if joins == "device":
        pprog.DEVICE_JOIN_N, mpc.DEVICE_REFINE_N = 1, 1
    try:
        cpu = super5(seqs, refine_iters=2, device="cpu")
        before = djc.LAUNCHES["densify_reduce_list"]
        card = super5(seqs, refine_iters=2, device=cuda_device)
        launched = djc.LAUNCHES["densify_reduce_list"] - before
    finally:
        pprog.DEVICE_JOIN_N, mpc.DEVICE_REFINE_N = saved
    assert card.to_fasta_text() == cpu.to_fasta_text()
    assert (launched > 0) == (joins == "device")


@pytest.mark.cuda
@pytest.mark.parametrize("cc1,cc2", [(1, 1), (37, 50), (300, 768),
                                     (20, 20000), (3, 40000)])
def test_mea_dirs_kernel_matches_plain(cuda_device, cc1, cc2):
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    gen = torch.Generator(device=cuda_device).manual_seed(cc1 + cc2)
    post = torch.rand((cc1, cc2), generator=gen, device=cuda_device) ** 3
    packed, scores = djc.mea_dirs(post)
    want_p, want_s = djc.mea_dirs_plain(post)
    torch.cuda.synchronize()
    assert torch.equal(packed, want_p)
    assert torch.equal(scores, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("cc1,cc2", [(1, 33), (23, 16), (40, 57), (130, 150),
                                     (767, 769), (1100, 300), (1500, 5000)])
def test_mea_dirs_wave_matches_plain(cuda_device, cc1, cc2, kind):
    """The wavefront over rows at odd shapes, one band, bands wrapping
    past 16 warps (the link row), on random and tie-heavy posteriors
    (mostly zeros: the tie order B, X, Y decides every such cell)."""
    from muscle_tpu_torch.ops import devjoin_cuda as djc
    from muscle_tpu_torch.ops import wavefront
    rng = np.random.default_rng(cc1 * cc2)
    if kind == "random":
        post = rng.random((cc1, cc2), dtype=np.float32)
    else:
        post = rng.choice(np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5]),
                          size=(cc1, cc2))
    post = torch.as_tensor(post, device=cuda_device)
    packed, scores = djc.mea_dirs(post)
    want_p, want_s = djc.mea_dirs_plain(post)
    torch.cuda.synchronize()
    wavefront.check_waits(cuda_device)
    assert torch.equal(packed, want_p)
    assert torch.equal(scores, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 384, 640, 2048, 2176, 12288])
def test_bwd_wave_matches_plain(cuda_device, width):
    """Kernel 3 on the wave (G = 2, 3, 2, 4, 2, 4: the geometry's at each
    width, one to 48 groups a pair) against bwd_plain on every cell, rows
    u >= lx zero: 2 pairs, one padded inside a segment, one at half the
    width."""
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    rng = np.random.default_rng(width)
    dev = cuda_device
    lx = torch.tensor([96, 61], dtype=torch.int32, device=dev)
    ly = torch.tensor([width - 7, width // 2 + 33], dtype=torch.int32,
                      device=dev)
    e = torch.as_tensor(rng.random((2, 96, width), dtype=np.float32) * 4 - 3,
                        device=dev)
    ins_x = torch.as_tensor(-1 - rng.random((2, 96), dtype=np.float32),
                            device=dev)
    ins_y = torch.as_tensor(-1 - rng.random((2, width), dtype=np.float32),
                            device=dev)
    params = pc.params_vec(HMMParams.from_defaults().to_scores(), dev)
    args = (e, ins_x, ins_y, lx, ly, params)
    got = pe.pairhmm_bwd(*args)
    torch.cuda.synchronize()
    wavefront.check_waits(dev)
    assert torch.equal(got, pe.bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_consistency_sparse_on_card_matches_cpu(cuda_device, precision):
    """The card's products (f32 with TF32 off, or bf16 with an f32
    result) against the CPU's on the same store: only the order of the
    f32 sums differs."""
    from muscle_tpu_torch.ops import consistency as cons
    rng = np.random.default_rng(4)
    n, l, k = 40, 64, 8
    p1 = n * (n - 1) // 2 + 1
    vals, cols = _store(rng, p1, l, k, max_nnz=5)
    v, c = torch.from_numpy(vals), torch.from_numpy(cols)
    want = cons.consistency_sparse(v, c, n, 2, seq_block=8,
                                   precision=precision)
    got = cons.consistency_sparse(v.to(cuda_device), c.to(cuda_device), n, 2,
                                  seq_block=8, precision=precision)
    assert float((got.cpu() - want).abs().max()) < 1e-5
    assert not got[-1].any()


@pytest.mark.cuda
def test_device_refine_on_card_matches_host_refine(cuda_device):
    """ROADMAP item 8's gate on the card: device joins give the host
    joins' alignment (a 16-sequence family, the joiner forced)."""
    from muscle_tpu_torch import MultiSequence, Sequence, align
    from muscle_tpu_torch.pipeline import mpc
    rng = np.random.default_rng(3)
    base = rng.integers(0, 20, size=110)
    seqs = MultiSequence()
    for i in range(16):
        ln = int(rng.integers(60, 111))
        mut = base[:ln].copy()
        pos = rng.integers(0, ln, size=int(rng.integers(0, ln // 3)))
        mut[pos] = rng.integers(0, 20, size=len(pos))
        seqs.add(Sequence(f"s{i}", "".join("ARNDCQEGHILKMFPSTWYV"[a]
                                             for a in mut)))
    host = align(seqs, refine_iters=12, device=cuda_device)
    saved = mpc.DEVICE_REFINE_N
    mpc.DEVICE_REFINE_N = 1
    try:
        dev = align(seqs, refine_iters=12, device=cuda_device)
    finally:
        mpc.DEVICE_REFINE_N = saved
    assert {s.label: s.text() for s in host} == \
        {s.label: s.text() for s in dev}


# ---------------------------------------------------------------------------
# long pairs: kernels A/B at the top rung Ly = 10240, and the Y-striped
# kernels 5/6 (ops/pairhmm_striped.py)
# ---------------------------------------------------------------------------

def test_stripe_kernel_build_flags(monkeypatch):
    from muscle_tpu_torch.ops import pairhmm_striped as ps
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    specs = ps.kernel_specs()
    assert [s.name for s in specs] == ["pairhmm_fwd_stripe",
                                       "pairhmm_bwd_stripe"]
    for spec in specs:
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        # kernels 7 and 7L share one body: an edit to it rebuilds both
        assert (any(d.endswith("csrc/densify_reduce.cuh") for d in spec.deps)
                == spec.name.startswith("densify_reduce"))
        assert any(d.endswith("pairhmm_common.cuh") for d in spec.deps)
        # kernels 5 and 6 share the wavefront's hand-over
        assert any(d.endswith("csrc/stripe_wavefront.cuh")
                   for d in spec.deps)


@pytest.mark.cuda
def test_kernels_match_twins_at_top_rung(cuda_device):
    xb, yb, lx, ly = _batch(2, 120, 128, 8, False)
    yb = np.full((2, 10240), 20, np.int32)
    ly = np.array([10240, 9731], np.int32)
    rng = np.random.default_rng(9)
    for i in range(2):
        yb[i, :ly[i]] = rng.integers(0, 21, size=ly[i])
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), cuda_device)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, *tabs)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, *tabs)
    tot = pc._total_prob(fend, tabs[2])
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, *tabs, tot, fm)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, *tabs, tot, fm)
    torch.cuda.synchronize()
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)


# phase 2's 512 and chip_smoke.py's AB_CHECK_WIDTHS: S = 1..5, with and
# without idle segment slots, and the long-pair router's rungs
AB_WIDTHS = (512, 2176, 4352, 6272, 8192, 8704, 9728, 10240)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["block", "wave"])
@pytest.mark.parametrize("width", AB_WIDTHS)
def test_ab_schedules_match_plain(cuda_device, width, schedule):
    """Kernels A and B forced onto each schedule (ab_geometry) against
    their plain versions, equal bit for bit on a full-width pair, one
    whose padding starts inside a segment and a short one; each launch
    counted once, under its schedule and width."""
    rng = np.random.default_rng(width)
    lx = np.array([96, 80, 33], np.int32)
    ly = np.array([width, width - 131, 100], np.int32)
    xb = np.full((3, 96), 20, np.int32)
    yb = np.full((3, width), 20, np.int32)
    for i in range(3):
        xb[i, :lx[i]] = rng.integers(0, 20, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 20, ly[i])
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), cuda_device)
    before = dict(pc.LAUNCHES)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, *tabs, schedule=schedule)
    tot = pc._total_prob(fend, tabs[2]).contiguous()
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, *tabs, tot, fm,
                                    schedule=schedule)
    torch.cuda.synchronize()
    pc.wavefront.check_waits(cuda_device)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, *tabs)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, *tabs, tot, fm)
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)
    for name in ("pairhmm_fwd", "pairhmm_bwd_post"):
        assert pc.LAUNCHES[name] == before[name] + 1
        assert pc.SCHEDULES[(name, schedule, width)] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 17])
def test_wave_per_pair_tables_and_groups(cuda_device, g):
    """Kernels 1M/2M (per-pair tables) on the wave at 2176 (34 segments)
    with groups of 1, 2 and 17 segments, equal to the plain versions;
    letter_path on the router's shape (B = 2 at 2176) takes the wave by
    itself and gives the block schedule's posteriors."""
    xb, yb, lx, ly = _batch(4, 150, 160, 21, False)
    yb = np.full((4, 2176), 20, np.int32)
    ly = np.array([2176, 2000, 1500, 64], np.int32)
    rng = np.random.default_rng(g)
    for i in range(4):
        yb[i, :ly[i]] = rng.integers(0, 21, ly[i])
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    _, (m, i, st, tv) = _multi_tables(cuda_device, [k % 4 for k in range(4)])
    m, i, p = m.contiguous(), i.contiguous(), pc.params_rows(st, tv)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, m, i, p, schedule="wave", g=g)
    tot = pc._total_prob(fend, p).contiguous()
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, m, i, p, tot, fm,
                                    schedule="wave", g=g)
    torch.cuda.synchronize()
    pc.wavefront.check_waits(cuda_device)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, m, i, p)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, m, i, p, tot, fm)
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)
    pack = HMMParams.from_defaults().to_scores()
    assert pc.ab_geometry(2, 2176).schedule == "wave"
    before = pc.SCHEDULES[("pairhmm_fwd", "wave", 2176)]
    post_w, ea_w = pc.batch_posteriors_cuda(x[:2], y[:2], lxt[:2], lyt[:2],
                                            pack)
    assert pc.SCHEDULES[("pairhmm_fwd", "wave", 2176)] == before + 1
    match, insert, params = pc.tables(pack, cuda_device)
    args = (x[:2], y[:2], lxt[:2], lyt[:2], match, insert, params)
    fm_b, fend_b = pc.pairhmm_fwd(*args, schedule="block")
    post_b, mea_b = pc.pairhmm_bwd_post(
        *args, pc._total_prob(fend_b, params).contiguous(), fm_b,
        schedule="block")
    assert torch.equal(post_w, post_b)
    assert torch.equal(ea_w, mea_b / torch.minimum(lxt[:2], lyt[:2]).float())


@pytest.mark.cuda
def test_wrapper_raises_past_top_rung(cuda_device):
    xb, yb, lx, ly = _batch(2, 60, 10368, 0, False)
    with pytest.raises(ValueError):
        pc.batch_posteriors_cuda(
            *(torch.from_numpy(a).to(cuda_device) for a in (xb, yb, lx, ly)),
            HMMParams.from_defaults().to_scores())


@pytest.mark.cuda
@pytest.mark.parametrize("w,g", [(256, 1), (256, 2), (256, 4), (2048, 1),
                                 (2048, 2), (2048, 8), (2048, 32)])
def test_stripe_kernels_match_twins(cuda_device, w, g):
    """One launch a pass, groups of g segments, against the whole-pass
    twins on the same inputs: M lattice, final states, posteriors and
    MEA equal bit for bit, on ragged pairs whose padding starts inside a
    group, at a stripe edge and one lane past it; the orchestration
    launches each kernel once."""
    from muscle_tpu_torch.ops import pairhmm_striped as ps
    rng = np.random.default_rng(w + g)
    n_s, bx = 3, 200
    by = n_s * w
    lx = np.array([200, 150, 37, 199, 64, 120], np.int32)
    ly = np.array([by, by - 5, w, w + 1, 2 * w - 3, 64 * 3 + 17], np.int32)
    xb = np.full((6, bx), 20, np.int32)
    yb = np.full((6, by), 20, np.int32)
    for i in range(6):
        xb[i, :lx[i]] = rng.integers(0, 20, lx[i])
        yb[i, :ly[i]] = rng.integers(0, 20, ly[i])
    pack = HMMParams.from_defaults().to_scores()
    tabs = pc.tables(pack, cuda_device)
    args = tuple(torch.from_numpy(a).to(cuda_device)
                 for a in (xb, yb, lx, ly)) + tabs
    iy0, jy0, iy0b, jy0b = ps.row0_closed_forms(args[1], args[3], tabs[1],
                                                tabs[2])
    before = dict(ps.LAUNCHES)
    fm, fend = ps.pairhmm_fwd_striped(*args, iy0, jy0, w, g)
    fm2, fend2 = ps.fwd_striped_plain(*args, iy0, jy0, w)
    torch.cuda.synchronize()
    assert torch.equal(fm, fm2) and torch.equal(fend, fend2)
    tot = pc._total_prob(fend, tabs[2]).contiguous()
    post, mea = ps.pairhmm_bwd_striped(*args, tot, iy0b, jy0b, fm, w, g)
    post2, mea2 = ps.bwd_striped_plain(*args, tot, iy0b, jy0b, fm2, w)
    torch.cuda.synchronize()
    ps.wavefront.check_waits(cuda_device)
    assert post.data_ptr() == fm.data_ptr()    # in place
    assert torch.equal(post, post2) and torch.equal(mea, mea2)
    assert ps.LAUNCHES["pairhmm_fwd_stripe"] == \
        before["pairhmm_fwd_stripe"] + 1
    assert ps.LAUNCHES["pairhmm_bwd_stripe"] == \
        before["pairhmm_bwd_stripe"] + 1
    ps.striped_posteriors_sparse(*(torch.from_numpy(a).to(cuda_device)
                                   for a in (xb, yb, lx, ly)), pack,
                                 stripe_w=w, g=g)
    assert ps.LAUNCHES["pairhmm_fwd_stripe"] == \
        before["pairhmm_fwd_stripe"] + 2
    assert ps.LAUNCHES["pairhmm_bwd_stripe"] == \
        before["pairhmm_bwd_stripe"] + 2


@pytest.mark.cuda
def test_long_family_on_card(cuda_device):
    """align() on the card through the long-pair router, its limits
    shrunk so that every kernel route runs: a valid alignment."""
    from muscle_tpu_torch import MultiSequence, Sequence, align
    from muscle_tpu_torch.pipeline import posteriors as post_mod
    rng = np.random.default_rng(5)
    base = rng.integers(0, 20, 640)
    seqs = MultiSequence()
    for i, n in enumerate((640, 250, 600, 200, 400)):
        mut = base[:n].copy()
        pos = rng.integers(0, n, size=n // 5)
        mut[pos] = rng.integers(0, 20, size=len(pos))
        seqs.add(Sequence(f"s{i}", "".join("ARNDCQEGHILKMFPSTWYV"[a]
                                             for a in mut)))
    saved = {k: getattr(post_mod, k) for k in (
        "LONG_PAIR_THRESHOLD", "SMALL_DENSE_NL", "_LONG_PALLAS_MAX_LY",
        "_LONG_PALLAS_CELL_BUDGET", "_STRIPE_W", "_STRIPED_CELL_BUDGET")}
    post_mod.LONG_PAIR_THRESHOLD = 256
    post_mod.SMALL_DENSE_NL = 512       # the pair store, not the dense branch
    post_mod._LONG_PALLAS_MAX_LY = 256
    post_mod._LONG_PALLAS_CELL_BUDGET = 1024 * 256
    post_mod._STRIPE_W = 128
    post_mod._STRIPED_CELL_BUDGET = 640 * 640
    post_mod.reset_routes()
    try:
        msa = align(seqs, refine_iters=4, device=cuda_device)
    finally:
        for k, v in saved.items():
            setattr(post_mod, k, v)
    assert all(v > 0 for k, v in post_mod.ROUTES.items() if k != "scan")
    assert {s.label: s.text().replace("-", "") for s in msa} == \
        {s.label: s.text() for s in seqs}


# ---------------------------------------------------------------------------
# the Muscle-3D kernels 1E, 2E, 3 and 4 (ops/pairhmm_emis_cuda.py)
# ---------------------------------------------------------------------------

def _mega_lattice(b, lx_max, width, seed, device="cpu"):
    """Emission lattice (B, lx_max, width) and insert scores of b pairs of
    a synthetic 8-feature .mega set (tests/mega_synth.py): chains of
    width - 150 .. width - 20 residues, x cut to its first lx_max."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mega_synth import mega_text
    from muscle_tpu_torch.io.mega import parse_mega
    from muscle_tpu_torch.ops import emissions as em
    ms = parse_mega(mega_text(b + 1, width - 150, width - 20, seed))
    prof = torch.as_tensor(em.pad_profiles(ms.profiles, width), device=device)
    lens = np.array([p.shape[0] for p in ms.profiles], np.int32)
    w, lp, lpm = em.mega_feature_arrays(ms, device)
    px, py = prof[:b, :lx_max], prof[1:]
    lx = np.minimum(lens[:b], lx_max - np.arange(b)).astype(np.int32)
    e = em.mega_emission_matrix(px, py, w, lpm)
    return (e, em.mega_insert_scores(px, w, lp), em.mega_insert_scores(py, w, lp),
            torch.as_tensor(lx, device=device),
            torch.as_tensor(lens[1:], device=device))


def test_emis_kernel_build_flags(monkeypatch):
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    specs = pe.kernel_specs()
    assert [s.name for s in specs] == ["pairhmm_fwd_emis",
                                       "pairhmm_bwd_post_emis",
                                       "pairhmm_bwd", "mea_scores"]
    for spec in specs:
        assert "arch=compute_90a,code=sm_90a" in spec.flags
        assert "-fmad=false" in spec.flags
        assert spec.sources[0].endswith(f"csrc/{spec.name}.cu")
        # kernels 7 and 7L share one body: an edit to it rebuilds both
        assert (any(d.endswith("csrc/densify_reduce.cuh") for d in spec.deps)
                == spec.name.startswith("densify_reduce"))
    for spec in specs[:3]:
        assert any(d.endswith("pairhmm_common.cuh") for d in spec.deps)
    # kernels A and B are built from the headers they share with 1E, 2E
    assert all(any(d.endswith(h) for d in s.deps) for s in pc.kernel_specs()
               for h in ("pairhmm_fwd.cuh", "pairhmm_bwd_post.cuh"))


def test_emis_cpu_tensors_run_plain_versions_and_count_nothing():
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    e, ins_x, ins_y, lx, ly = _mega_lattice(2, 128, 128, 3)
    pack = HMMParams.from_defaults().to_scores()
    before = dict(pe.LAUNCHES)
    post, ea = pe.batch_posteriors_emissions_cuda(e, ins_x, ins_y, lx, ly,
                                                  pack)
    assert pe.LAUNCHES == before
    assert post.shape == (2, 128, 128) and bool((ea > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lx_max,width", [(384, 384), (256, 2048),
                                          (192, 12288)],
                         ids=["S1", "S1-2048", "S6-12288"])
def test_emis_kernels_match_plain(cuda_device, lx_max, width):
    """Kernels 1E, 2E (up to FUSED_MAX_LY), 3 and 4 against their plain
    versions on the card, equal bit for bit (1E on the real cells)."""
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    e, ins_x, ins_y, lx, ly = _mega_lattice(4, lx_max, width, 4,
                                            cuda_device)
    params = pc.params_vec(HMMParams.from_defaults().to_scores(),
                           cuda_device)
    lx, ly = lx.int(), ly.int()
    fm, fend = pe.pairhmm_fwd_emis(e, ins_x, ins_y, lx, ly, params)
    fm2, fend2 = pe.fwd_emis_plain(e, ins_x, ins_y, lx, ly, params)
    assert torch.equal(_real(fm, lx, ly), _real(fm2, lx, ly))
    assert torch.equal(fend, fend2)
    tot = pc._total_prob(fend, params)
    if width <= pe.FUSED_MAX_LY:
        post, mea = pe.pairhmm_bwd_post_emis(e, ins_x, ins_y, lx, ly, params,
                                             tot, fm)
        post2, mea2 = pe.bwd_post_emis_plain(e, ins_x, ins_y, lx, ly,
                                             params, tot, fm)
        assert torch.equal(post, post2) and torch.equal(mea, mea2)
    rb = pe.pairhmm_bwd(e, ins_x, ins_y, lx, ly, params)
    assert torch.equal(rb, pe.bwd_plain(e, ins_x, ins_y, lx, ly, params))
    post = pe.finish_posteriors(fm, rb, fend, lx, ly, params)
    assert torch.equal(pe.mea_scores(post, lx, ly), pe.mea_scores_plain(post))
    pe.wavefront.check_waits(cuda_device)


@pytest.mark.cuda
def test_lattice_kernels_equal_letter_kernels(cuda_device):
    """Fed the letter lattice match[x_i, y_j], kernels 1E and 2E give
    kernels A and B's bits."""
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    xb, yb, lx, ly = _batch(16, 300, 384, 5, False)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    match, insert, params = pc.tables(HMMParams.from_defaults().to_scores(),
                                      cuda_device)
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, match, insert, params)
    tot = pc._total_prob(fend, params)
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, match, insert, params,
                                    tot, fm)
    e = match[x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    ins_x = insert[x.long()].contiguous()
    ins_y = insert[y.long()].contiguous()
    fm2, fend2 = pe.pairhmm_fwd_emis(e, ins_x, ins_y, lxt, lyt, params)
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
    post2, mea2 = pe.pairhmm_bwd_post_emis(e, ins_x, ins_y, lxt, lyt, params,
                                           tot, fm)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)


@pytest.mark.cuda
def test_mega_align_on_card_matches_cpu(cuda_device):
    """align(mega=) on the card (kernels 1E/2E) gives the CPU's text."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mega_synth import mega_text
    from muscle_tpu_torch import MultiSequence, Sequence, align
    from muscle_tpu_torch.io.mega import parse_mega
    ms = parse_mega(mega_text(6, 200, 260, 8))
    seqs = MultiSequence([Sequence(lb, s) for lb, s in zip(ms.labels, ms.seqs)])
    card = align(seqs, mega=ms, device=cuda_device)
    cpu = align(seqs, mega=ms, device="cpu")
    assert card.to_fasta_text() == cpu.to_fasta_text()


# ---------------------------------------------------------------------------
# the ensembles' kernels: 1M / 2M (per-pair tables) and 3K (the letter
# path's legacy backward)
# ---------------------------------------------------------------------------

def _multi_tables(device, reps, seeds=(0, 3, 7, 11)):
    """Per-lane tables (match, insert, start, tv) from packs of the
    given perturbation seeds, lane i taking pack reps[i]."""
    from muscle_tpu_torch.ops import pairhmm as ph
    packs = []
    for s in seeds:
        hp = HMMParams.from_defaults()
        if s:
            hp.perturb(s)
        packs.append(hp.to_scores())
    return packs, ph.score_args_multi(packs, reps, device)


def test_ensemble_kernel_specs_and_cpu_route(monkeypatch):
    """3K builds from csrc/pairhmm_bwd_codes.cu, keyed on the kernel-3
    header it shares; on CPU tensors both routes of the multi entry
    point run the plain versions and count nothing."""
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    spec = next(s for s in pc.kernel_specs() if s.name == "pairhmm_bwd_codes")
    assert spec.sources[0].endswith("csrc/pairhmm_bwd_codes.cu")
    assert any(d.endswith("pairhmm_bwd.cuh") for d in spec.deps)
    xb, yb, lx, ly = _batch(4, 60, 128, 1, False)
    _, tabs = _multi_tables("cpu", [0, 1, 2, 3])
    before = dict(pc.LAUNCHES)
    for fused in (True, False):
        post, ea = pc.batch_posteriors_cuda_multi(
            *(torch.from_numpy(a) for a in (xb, yb, lx, ly)), *tabs,
            fused=fused)
        assert post.shape == (4, 128, 128) and bool((ea > 0).all())
    assert pc.LAUNCHES == before


def _assert_rbm_equal(rb, want, lx, ly):
    """Kernel 3K's RB_M equal to its plain version on the real cells (rows
    u < lx, lanes v < ly: all that finish_posteriors reads; the block
    body leaves its segments past ly unwritten) and zero in rows u >=
    lx."""
    assert torch.equal(_real(rb, lx, ly), _real(want, lx, ly))
    for k, n in enumerate(lx.tolist()):
        assert not rb[k, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,lmax,width", [(16, 300, 384), (4, 900, 1024)],
                         ids=["384", "1024"])
def test_multi_and_legacy_kernels_match_plain(cuda_device, b, lmax, width):
    """1M, 2M and 3K against their plain versions (max |d| = 0), each
    lane against the single-pack kernels A/B on its pack, 1E/2E with
    per-pair params on the per-pair lattice against 1M/2M, and the
    legacy route against the fused one at the kernel gate."""
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    xb, yb, lx, ly = _batch(b, lmax, width, 9, False)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    reps = [i % 4 for i in range(b)]
    packs, (m, i, s, t) = _multi_tables(cuda_device, reps)
    p = pc.params_rows(s, t)
    m, i = m.contiguous(), i.contiguous()
    fm, fend = pc.pairhmm_fwd(x, y, lxt, lyt, m, i, p)
    fm2, fend2 = pc.fwd_plain(x, y, lxt, lyt, m, i, p)
    assert torch.equal(_real(fm, lxt, lyt), _real(fm2, lxt, lyt))
    assert torch.equal(fend, fend2)
    tot = pc._total_prob(fend, p)
    post, mea = pc.pairhmm_bwd_post(x, y, lxt, lyt, m, i, p, tot, fm)
    post2, mea2 = pc.bwd_post_plain(x, y, lxt, lyt, m, i, p, tot, fm)
    assert torch.equal(post, post2) and torch.equal(mea, mea2)
    rb = pc.pairhmm_bwd_codes(x, y, lxt, lyt, m, i, p)
    _assert_rbm_equal(rb, pc.bwd_codes_plain(x, y, lxt, lyt, m, i, p), lxt,
                      lyt)
    for r, pack in enumerate(packs):
        lanes = torch.as_tensor([k for k in range(b) if reps[k] == r],
                                device=cuda_device)
        tabs = pc.tables(pack, cuda_device)
        fm1, fend1 = pc.pairhmm_fwd(x, y, lxt, lyt, *tabs)
        post1, mea1 = pc.pairhmm_bwd_post(x, y, lxt, lyt, *tabs,
                                          pc._total_prob(fend1, tabs[2]),
                                          fm1)
        assert torch.equal(fend[lanes], fend1[lanes])
        assert torch.equal(post[lanes], post1[lanes])
        assert torch.equal(mea[lanes], mea1[lanes])
        assert torch.equal(_real(rb, lxt, lyt)[lanes], _real(
            pc.pairhmm_bwd_codes(x, y, lxt, lyt, *tabs), lxt, lyt)[lanes])
    ar = torch.arange(b, device=cuda_device)[:, None, None]
    e = m[ar, x.long()[:, :, None], y.long()[:, None, :]].contiguous()
    ins_x = torch.gather(i, 1, x.long()).contiguous()
    ins_y = torch.gather(i, 1, y.long()).contiguous()
    fm3, fend3 = pe.pairhmm_fwd_emis(e, ins_x, ins_y, lxt, lyt, p)
    assert torch.equal(_real(fm3, lxt, lyt), _real(fm, lxt, lyt))
    assert torch.equal(fend3, fend)
    post3, mea3 = pe.pairhmm_bwd_post_emis(e, ins_x, ins_y, lxt, lyt, p, tot,
                                           fm)
    assert torch.equal(post3, post) and torch.equal(mea3, mea)
    post4, ea4 = pc.batch_posteriors_cuda_multi(x, y, lxt, lyt, m, i, s, t,
                                                fused=False)
    torch.cuda.synchronize()
    ea = mea / torch.minimum(lxt, lyt).float()
    d = (post4 - post).abs()
    flip = ((post4 == 0) | (post == 0)) & \
        (torch.maximum(post4, post) <= 0.0102)
    assert float(d.where(~flip, 0.0).max()) < 2e-3
    assert float((ea4 - ea).abs().max()) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("per_pair", [False, True], ids=["shared",
                                                         "per-pair"])
@pytest.mark.parametrize("width", [2176, 4096])
def test_bwd_codes_wave_matches_plain(cuda_device, width, per_pair):
    """Kernel 3K on the wave (above 2048 lanes) against its plain version
    (max |d| = 0 on every cell: the wave writes every lane), with one
    table set and one a pair; its hand-over checked."""
    from muscle_tpu_torch.ops import wavefront
    xb, yb, lx, ly = _batch(4, width, width, width, False)
    xb, lx = np.ascontiguousarray(xb[:, :96]), np.minimum(lx, 96)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    if per_pair:
        _, (m, i, s, t) = _multi_tables(cuda_device, [0, 1, 2, 3])
        tabs = (m.contiguous(), i.contiguous(), pc.params_rows(s, t))
    else:
        tabs = pc.tables(HMMParams.from_defaults().to_scores(), cuda_device)
    assert pc.bwd_codes_geometry(4, width).schedule == "wave"
    before = pc.SCHEDULES[("pairhmm_bwd_codes", "wave", width)]
    rb = pc.pairhmm_bwd_codes(x, y, lxt, lyt, *tabs)
    torch.cuda.synchronize()
    wavefront.check_waits(cuda_device)
    assert pc.SCHEDULES[("pairhmm_bwd_codes", "wave", width)] == before + 1
    assert torch.equal(rb, pc.bwd_codes_plain(x, y, lxt, lyt, *tabs))


@pytest.mark.cuda
@pytest.mark.parametrize("b,width,want", [(4, 1024, "wave"),
                                          (160, 768, "block"),
                                          (16, 2048, "wave")])
def test_bwd_codes_schedules_match_plain(cuda_device, b, width, want):
    """Kernel 3K at the widths where B picks its schedule (and at 2048,
    the block body's widest): the default schedule is `want`, and both
    schedules equal the plain version on the real cells and the zero
    rows u >= lx; their hand-over checked."""
    from muscle_tpu_torch.ops import wavefront
    xb, yb, lx, ly = _batch(b, width, width, b + width, False)
    xb, lx = np.ascontiguousarray(xb[:, :96]), np.minimum(lx, 96)
    x, y, lxt, lyt = (torch.from_numpy(a).to(cuda_device)
                      for a in (xb, yb, lx, ly))
    tabs = pc.tables(HMMParams.from_defaults().to_scores(), cuda_device)
    assert pc.bwd_codes_geometry(b, width).schedule == want
    plain = pc.bwd_codes_plain(x, y, lxt, lyt, *tabs)
    for schedule in ("block", "wave"):
        rb = pc.pairhmm_bwd_codes(x, y, lxt, lyt, *tabs, schedule=schedule)
        torch.cuda.synchronize()
        wavefront.check_waits(cuda_device)
        _assert_rbm_equal(rb, plain, lxt, lyt)


def _ragged_post(b, n_rows, width, seed, kind, device):
    """A (b, n_rows, width) posterior zero outside each pair's (lx, ly)
    (lengths from a third of the pad up, the first pair full), uniform
    or tie-heavy values; and lx, ly."""
    rng = np.random.default_rng(seed)
    lx = rng.integers(max(1, n_rows // 3), n_rows + 1, size=b)
    ly = rng.integers(max(1, width // 3), width + 1, size=b)
    lx[0], ly[0] = n_rows, width
    p = (rng.random((b, n_rows, width), dtype=np.float32) if kind == "random"
         else rng.choice(np.float32([0, 0, 0, 0, 0, 0, 0.25, 0.5]),
                         size=(b, n_rows, width)))
    r = np.arange(n_rows)[None, :, None]
    c = np.arange(width)[None, None, :]
    p = np.where((r < lx[:, None, None]) & (c < ly[:, None, None]), p, 0.0)
    return (torch.as_tensor(p.astype(np.float32), device=device),
            torch.as_tensor(lx.astype(np.int32), device=device),
            torch.as_tensor(ly.astype(np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "tie-heavy"])
@pytest.mark.parametrize("b,n_rows,width", [(8, 2000, 2048), (64, 512, 512),
                                            (2, 96, 16896)],
                         ids=["8x2048", "64x512", "2x16896"])
def test_mea_scores_kernel_matches_plain(cuda_device, b, n_rows, width,
                                         kind):
    """Kernel 4 (bands of rows across SMs) against its plain version, max
    |d| = 0, at its warps and at 1 and 5 warps a block (more rounds, more
    links between blocks), past 16384 lanes too; its hand-over checked
    (`check_waits` raises on a wait past the limit)."""
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    post, lx, ly = _ragged_post(b, n_rows, width, b + n_rows + width, kind,
                                cuda_device)
    want = pe.mea_scores_plain(post)
    before = pe.LAUNCHES["mea_scores"]
    for warps in (None, 1, 5):
        assert torch.equal(pe.mea_scores(post, lx, ly, warps=warps), want)
        pe.wavefront.check_waits(cuda_device)
    assert pe.LAUNCHES["mea_scores"] == before + 3


@pytest.mark.cuda
def test_ensemble_on_card_matches_cpu(cuda_device, tmp_path):
    """-replicates 3 through run_align_command on the card (kernels 1M
    and 2M) gives the CPU's EFA; the legacy route's align of BB11001
    launches kernel 3K and gives an alignment of its input."""
    from muscle_tpu_torch import MultiSequence, align
    from muscle_tpu_torch.pipeline.ensemble import run_align_command
    inp = tmp_path / "in.fa"
    inp.write_text(MultiSequence.from_fasta(
        os.path.join(ROOT, "tests", "goldens", "BB11002.seq.afa"),
        strip_gaps=True).to_fasta_text())
    texts = []
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.efa"
        run_align_command("align", str(inp), str(out),
                          {"replicates": "3", "refineiters": "10",
                           "device": dev})
        texts.append(out.read_text())
    assert texts[0] == texts[1]
    seqs = MultiSequence.from_fasta(
        os.path.join(ROOT, "tests", "goldens", "BB11001.seq.afa"),
        strip_gaps=True)
    before = pc.LAUNCHES["pairhmm_bwd_codes"]
    saved = pc.FUSED
    pc.FUSED = False
    try:
        legacy = align(seqs, device=cuda_device)
    finally:
        pc.FUSED = saved
    assert pc.LAUNCHES["pairhmm_bwd_codes"] > before
    assert {s.label: s.text().replace("-", "") for s in legacy} == \
        {s.label: s.text() for s in seqs}
