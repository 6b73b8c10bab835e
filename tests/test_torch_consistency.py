"""The Gram-scheme consistency of muscle_tpu_torch on the CPU, against
muscle_tpu on the same numpy-seeded sparse stores.

* `densify` (plain version of kernel 8) equals muscle_tpu's XLA densify
  bit for bit, and the row panel equals the JAX package's
  `_densify_rowpanel` in f32 and in bf16;
* `consistency_sparse` is within 1e-5 of muscle_tpu's at both
  precisions, with the K-trim, and keeps the dump row zero;
* the Gram scheme is within 2e-5 of the port's own dense path;
* `consistency_precision_for` switches where the JAX package's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.ops import consistency as j_cons
from muscle_tpu.ops import sparse as j_sp
from muscle_tpu.pipeline import mpc as j_mpc
from muscle_tpu_torch.ops import consistency as t_cons
from muscle_tpu_torch.ops import densify_cuda as t_dc
from muscle_tpu_torch.ops import sparse as t_sp
from muscle_tpu_torch.pipeline import mpc as t_mpc


def _random_posts(rng, n, l, max_row_nnz=5):
    """(pairs, (P, l, l) posteriors): 1..max_row_nnz entries per row in
    [0.02, 0.92), as tests/test_consistency.py draws them."""
    pairs = [(x, y) for x in range(n) for y in range(x + 1, n)]
    p = len(pairs)
    cols = np.argsort(rng.random((p, l, l)), axis=-1)[..., :max_row_nnz]
    cnt = rng.integers(1, max_row_nnz + 1, size=(p, l, 1))
    vals = rng.random((p, l, max_row_nnz)) * 0.9 + 0.02
    vals = np.where(np.arange(max_row_nnz) < cnt, vals, 0.0)
    post = np.zeros((p, l, l), np.float32)
    np.put_along_axis(post, cols, vals.astype(np.float32), axis=-1)
    return pairs, post


def _store(rng, n, l, k, extra_rows=1):
    """A (P + extra_rows, l, k) store; the last row is the dump slot."""
    pairs, post = _random_posts(rng, n, l)
    vals, cols, mx = j_sp.sparsify(jnp.asarray(post), k)
    sv = np.concatenate([np.asarray(vals),
                         np.zeros((extra_rows, l, k), np.float32)])
    sc = np.concatenate([np.asarray(cols),
                         np.full((extra_rows, l, k), -1, np.int32)])
    return pairs, post, sv, sc, int(mx)


def test_densify_matches_jax():
    rng = np.random.default_rng(3)
    _, post, sv, sc, _ = _store(rng, 5, 48, 8)
    want = np.asarray(j_sp.densify(jnp.asarray(sv), jnp.asarray(sc), 48))
    got = t_sp.densify(torch.from_numpy(sv), torch.from_numpy(sc), 48)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[:len(post)], post)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_densify_panel_matches_jax_rowpanel(bf16):
    """Kernel 8's plain version writes the z-tile panel of the JAX
    package's _densify_rowpanel (orientation flags, dtype) bit for bit."""
    rng = np.random.default_rng(5)
    n, l, k, blk = 9, 32, 8, 4
    _, _, sv, sc, _ = _store(rng, n, l, k)
    nbp = 12
    pid, flag = j_cons._block_maps(n, nbp, sv.shape[0] - 1)
    tpid, tflag = t_cons._block_maps(n, nbp, sv.shape[0] - 1)
    assert np.array_equal(pid, tpid)
    assert np.array_equal(flag, tflag)
    for zi in range(-(-n // blk)):
        zs = slice(zi * blk, (zi + 1) * blk)
        want = j_cons._densify_rowpanel(
            jnp.asarray(sv), jnp.asarray(sc), jnp.asarray(pid[zs]),
            jnp.asarray(flag[zs]), t=blk, l=l, mode="scatter", bf16=bf16,
            cb=1)
        got = t_dc.densify_panel(
            torch.from_numpy(sv), torch.from_numpy(sc),
            torch.from_numpy(tpid[zs]), torch.from_numpy(tflag[zs]),
            torch.bfloat16 if bf16 else torch.float32)
        assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


@pytest.mark.parametrize("n,l,k,seq_block", [(11, 32, 8, 4),
                                             (40, 64, 8, 8)],
                         ids=["n11", "n40"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_consistency_sparse_matches_jax(n, l, k, seq_block, precision):
    """Same store, same blocking: only the order of the f32 sums inside
    each product differs. "default" rounds the panels to bf16 with the
    same round-to-nearest-even on both sides, so the same 1e-5 holds."""
    rng = np.random.default_rng(11 + n)
    # a K = 2k store trimmed back to k by max_nnz, plus padding rows
    _, _, sv, sc, mx = _store(rng, n, l, 2 * k, extra_rows=3)
    assert mx <= k
    want = np.asarray(j_cons.consistency_sparse(
        jnp.asarray(sv), jnp.asarray(sc), n, 2, seq_block=seq_block,
        precision=precision, max_nnz=mx))
    got = t_cons.consistency_sparse(
        torch.from_numpy(sv), torch.from_numpy(sc), n, 2,
        seq_block=seq_block, precision=precision, max_nnz=mx).numpy()
    assert got.shape == sv.shape
    assert np.abs(got - want).max() < 1e-5
    assert not got[-1].any(), "the dump row must stay zero"
    # the pattern is kept: values only where the store has a slot
    assert not got[sc < 0].any()


def test_consistency_gram_matches_dense_port():
    rng = np.random.default_rng(42)
    n, l, k = 7, 64, 16
    pairs, post, sv, sc, _ = _store(rng, n, l, k, extra_rows=4)
    xi = torch.tensor([p[0] for p in pairs])
    yi = torch.tensor([p[1] for p in pairs])
    t = torch.zeros((n, n, l, l))
    t[xi, yi] = torch.from_numpy(post)
    t[yi, xi] = torch.from_numpy(post).transpose(-1, -2)
    mask = t_cons.sparsity_mask(t)
    for _ in range(2):
        t = t_cons.consistency_iter(t, mask, n)
    dense = t[xi, yi].numpy()
    out = t_cons.consistency_sparse(torch.from_numpy(sv),
                                    torch.from_numpy(sc), n, 2, seq_block=4)
    got = t_sp.densify(out, torch.from_numpy(sc), l).numpy()[:len(pairs)]
    assert np.abs(got - dense).max() < 2e-5


@pytest.mark.parametrize("n", [31, 32])
def test_consistency_precision_for_matches_jax(n):
    assert t_mpc.consistency_precision_for(n) == \
        j_mpc.consistency_precision_for(n)
    assert t_mpc.consistency_precision_for(n, "highest") == "highest"
