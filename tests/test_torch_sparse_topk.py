"""The sparsify's top-K selection against the JAX package's lax.top_k.

`muscle_tpu_torch.ops.sparse.sparsify` launches a hand-written CUDA
kernel on the card (csrc/sparsify_topk.cu) and runs its plain version, a
stable sort of each row, on CPU tensors; `sparsify_schedule_model` runs
the kernel's own schedule (a warp's list of 32 * S keys, the row in
steps of 128 or 32 columns, more passes past 32 * S slots) on the CPU.
Both are held here, bit for bit, to `muscle_tpu.ops.sparse.sparsify`
(`jax.lax.top_k` on the CPU) on rows tied at one value, rows of exactly
K, K + 1 and 3K entries, all-zero rows, a lone entry in the last column
and values at the 0.01 threshold, at K = 16, 32 and 56 and widths a
multiple of 128 and not. The kernel against the plain version on the
card: tests/test_torch_cuda_topk.py. Also here: the legacy Muscle-3D
route run in sub-batches under a small memory budget equals one batch,
and a pair that cannot fit raises MemoryError.
"""

import numpy as np
import pytest
import torch

from mega_synth import mega_text
from muscle_tpu.ops import sparse as j_sparse
from muscle_tpu_torch.hmm.params import HMMParams
from muscle_tpu_torch.io import mega as t_mega
from muscle_tpu_torch.ops import pairhmm_cuda as t_cuda
from muscle_tpu_torch.ops import pairhmm_emis_cuda as t_emis
from muscle_tpu_torch.ops import sparse as t_sparse
from muscle_tpu_torch.pipeline import posteriors as t_post

THRESHOLD = np.float32(0.01)


def _rows(k: int, ly: int, seed: int) -> np.ndarray:
    """(2, R, ly) posterior rows of the listed kinds, zero elsewhere."""
    rng = np.random.default_rng(seed)
    rows = []

    def row_with(n, values=None):
        r = np.zeros(ly, np.float32)
        at = rng.choice(ly, size=min(n, ly), replace=False)
        r[at] = (rng.uniform(THRESHOLD, 1.0, size=len(at)).astype(np.float32)
                 if values is None else rng.choice(values, size=len(at)))
        return r

    tie = np.float32(0.25)
    rows.append(row_with(ly // 2, [tie]))                # one value, many cols
    rows.append(row_with(3 * k, [tie, np.float32(0.5)]))  # two values
    for n in (k, k + 1, 3 * k, 1, 5):
        rows.append(row_with(n))
    rows.append(np.zeros(ly, np.float32))                 # all zero
    last = np.zeros(ly, np.float32)
    last[-1] = 0.7
    rows.append(last)                                     # last column only
    edge = np.zeros(ly, np.float32)
    at = rng.choice(ly, size=min(2 * k, ly), replace=False)
    edge[at] = rng.choice(np.array(
        [THRESHOLD, np.nextafter(THRESHOLD, np.float32(1)),
         np.float32(0.0100001), np.float32(1.0)], np.float32), size=len(at))
    rows.append(edge)                                     # at the threshold
    dense = rng.uniform(0, 1, size=ly).astype(np.float32)
    dense[dense < 0.5] = 0
    rows.append(dense)                                    # half the row
    post = np.stack(rows)
    return np.stack([post, post[::-1] * np.float32(0.5)])


def _jax(post, k):
    v, c, n = j_sparse.sparsify(post, k)
    return np.asarray(v), np.asarray(c), int(n)


@pytest.mark.parametrize("k", [16, 32, 56])
@pytest.mark.parametrize("ly", [256, 300, 301])
def test_plain_and_model_equal_lax_top_k(k, ly):
    """The plain version and the kernel's schedule model equal lax.top_k
    bit for bit: values, columns, empty slots and the row-nnz max (256:
    16-byte steps of 128 columns; 300: the same with a ragged last
    step; 301: one column a lane)."""
    post = _rows(k, ly, seed=k * 1000 + ly)
    want = _jax(post, k)
    v, c, n = t_sparse.sparsify(torch.from_numpy(post), k)
    assert v.dtype == torch.float32 and c.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), want[0])
    np.testing.assert_array_equal(c.numpy(), want[1])
    assert int(n) == want[2]
    mv, mc, mn = t_sparse.sparsify_schedule_model(post, k)
    np.testing.assert_array_equal(mv, want[0])
    np.testing.assert_array_equal(mc, want[1])
    assert mn == want[2]


@pytest.mark.parametrize("k,stripes,vec", [(56, 1, True), (56, 1, False),
                                           (16, 2, True), (100, 1, True),
                                           (300, 8, True)])
def test_model_passes_and_stripes(k, stripes, vec):
    """The schedule's other cases: K past 32 * S (a second and third pass
    over the row, each below the last pass's last key), more stripes
    than K needs, one column a lane on a width that allows 16-byte
    steps, and K = 300 at the most stripes (two passes of 256)."""
    ly = 384
    post = _rows(max(k, 32), ly, seed=7 + k + stripes)
    want = _jax(post, k)
    mv, mc, mn = t_sparse.sparsify_schedule_model(post, k, stripes=stripes,
                                                  vec=vec)
    np.testing.assert_array_equal(mv, want[0])
    np.testing.assert_array_equal(mc, want[1])
    assert mn == want[2]


def test_stripes_and_cpu_route():
    """S follows K (a power of two, at most 8); CPU tensors run the plain
    version and launch nothing; the kernel's range is lax.top_k's."""
    assert [t_sparse.topk_stripes(k) for k in (1, 16, 32, 33, 56, 64, 65,
                                               200, 256, 257, 5000)] == \
        [1, 1, 1, 2, 2, 2, 4, 8, 8, 8, 8]
    before = dict(t_sparse.LAUNCHES)
    post = torch.from_numpy(_rows(16, 128, seed=3))
    t_sparse.sparsify(post, 16)
    assert t_sparse.LAUNCHES == before
    assert t_sparse.topk_vector_loads(post)
    assert not t_sparse.topk_vector_loads(post.transpose(1, 2))
    assert not t_sparse.topk_vector_loads(post[..., 1:])
    with pytest.raises(ValueError, match="CUDA"):
        t_sparse.sparsify_topk(post, 16)


def test_transposed_view_model():
    """A transposed posterior (the long-pair router's swapped pairs) read
    through its strides: the model on the view equals lax.top_k."""
    rng = np.random.default_rng(11)
    post = rng.choice(np.float32([0, 0, 0, 0, 0.25, 0.5, 0.75]),
                      size=(2, 64, 256)).astype(np.float32)
    view = torch.from_numpy(post).transpose(1, 2)
    want = _jax(np.ascontiguousarray(view.numpy()), 32)
    mv, mc, mn = t_sparse.sparsify_schedule_model(view, 32, vec=False)
    np.testing.assert_array_equal(mv, want[0])
    np.testing.assert_array_equal(mc, want[1])
    assert mn == want[2]


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_legacy_sub_batches_equal_one_batch(monkeypatch, one_thread):
    """The legacy route (FUSED_MAX_LY shrunk) of a 6-pair mega chunk at
    pad 128 under a memory budget that fits 2 pairs a sub-batch (the
    whole chunk's posterior beside them) equals the chunk in one batch
    bit for bit, posterior and EA, with one (16,) params vector and with
    (B, 16) rows; the store of all_pairs_posteriors_mega_sparse through
    the card's chunk function (its lattice built a sub-batch at a time)
    equals it too; a budget short of one pair raises MemoryError."""
    ms = t_mega.parse_mega(mega_text(4, 90, 128, 3))
    pad = 128
    pairs = [(x, y) for x in range(4) for y in range(x + 1, 4)]
    prof = torch.as_tensor(
        np.stack([np.pad(p, ((0, pad - len(p)), (0, 0))) for p in
                  ms.profiles]))
    lens = np.array([len(p) for p in ms.profiles], np.int32)
    from muscle_tpu_torch.ops import emissions as t_em
    w, lp, lpm = t_em.mega_feature_arrays(ms)
    xi = torch.as_tensor([x for x, _ in pairs])
    yi = torch.as_tensor([y for _, y in pairs])
    e = t_em.mega_emission_matrix(prof[xi], prof[yi], w, lpm)
    args = (e, t_em.mega_insert_scores(prof[xi], w, lp),
            t_em.mega_insert_scores(prof[yi], w, lp),
            torch.as_tensor(lens[xi.numpy()]), torch.as_tensor(
                lens[yi.numpy()]))
    pack = HMMParams.from_defaults().to_scores()
    params = t_cuda.params_vec(pack, "cpu")
    lxb, lyb = args[3].int(), args[4].int()
    budget = t_emis.legacy_need_bytes(6, 2, pad, pad)
    assert t_emis.legacy_sub_batch(6, pad, pad, budget) == 2
    assert t_emis.legacy_sub_batch(6, pad, pad, None) == 6
    for prm in (params, params.expand(6, 16).contiguous()):
        one = t_emis.emissions_path_legacy(*args[:3], lxb, lyb, prm)
        monkeypatch.setattr(t_emis, "free_bytes", lambda device: budget)
        subs = t_emis.emissions_path_legacy(*args[:3], lxb, lyb, prm)
        monkeypatch.undo()
        assert torch.equal(one[0], subs[0]) and torch.equal(one[1], subs[1])
    monkeypatch.setattr(t_emis, "FUSED_MAX_LY", 64)
    monkeypatch.setattr(t_post, "default_backend", lambda device: "cuda")
    profiles = prof.numpy()
    whole = t_post.all_pairs_posteriors_mega_sparse(
        profiles, lens, ms, pack, pairs, "cpu", k=16)
    # the store's chunk: 8 lanes (6 pairs and 2 fillers), 2 a sub-batch
    budget = t_emis.legacy_need_bytes(8, 2, pad, pad)
    assert t_emis.legacy_sub_batch(8, pad, pad, budget) == 2
    monkeypatch.setattr(t_emis, "free_bytes", lambda device: budget)
    t_emis.reset_routes()
    cut = t_post.all_pairs_posteriors_mega_sparse(
        profiles, lens, ms, pack, pairs, "cpu", k=16)
    assert t_emis.ROUTES == {"fused": 0, "legacy": 1}
    assert torch.equal(whole[0], cut[0]) and torch.equal(whole[1], cut[1])
    np.testing.assert_array_equal(whole[2], cut[2])
    assert whole[3] == cut[3]
    monkeypatch.setattr(t_emis, "free_bytes", lambda device: budget // 8)
    with pytest.raises(MemoryError, match=f"pad {pad}: "):
        t_emis.emissions_path_legacy(*args[:3], lxb, lyb, params)


def test_kernel_spec_constants_and_build_all(monkeypatch):
    """The kernel builds for sm_90a from csrc/sparsify_topk.cu with the
    others (build_all), and the constants mirrored in ops/sparse.py are
    the source's."""
    import os
    import re
    from muscle_tpu_torch.utils import build
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    (spec,) = t_sparse.kernel_specs()
    assert spec.name == "sparsify_topk"
    assert "arch=compute_90a,code=sm_90a" in spec.flags
    assert spec.sources[0].endswith(os.path.join("csrc", "sparsify_topk.cu"))
    seen = []
    monkeypatch.setattr(build, "ensure_built",
                        lambda specs: seen.extend(s.name for s in specs))
    build.build_all()
    assert "sparsify_topk" in seen and len(seen) == len(set(seen))
    with open(spec.sources[0]) as fh:
        src = fh.read()
    assert int(re.search(r"kWarps = (\d+);", src).group(1)) == \
        t_sparse.TOPK_WARPS
    cases = re.findall(r"case (\d+):\n\s+launch<(\d+)>", src)
    assert [int(a) for a, b in cases] == [int(b) for a, b in cases] == \
        [1, 2, 4, t_sparse.TOPK_MAX_STRIPES]
