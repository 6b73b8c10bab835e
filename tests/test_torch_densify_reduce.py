"""Kernels 7 and 7L's launch geometry and plain versions on the CPU.

* `_geometry` (ops/devjoin_cuda.py) keeps a block's shared memory
  within the card's 227 KB and four blocks to an SM, covers cc, and cuts
  cc = 13000 into column tiles whose stores stay 16-byte aligned;
* `densify_reduce_plain` and `densify_reduce_list_plain` equal numpy
  loops over the entries in order, bit for bit, on rows with all 32
  slots valid and on a row-owner whose entries are all the dump row.

The kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.ops import devjoin_cuda as djc

SMEM_PER_BLOCK = 232448      # H100: 227 KB a block
SMEM_PER_SM = 233472         # 228 KB an SM, 1 KB of it kept per block


@pytest.mark.parametrize("cc", [45, 490, 768, 1051, 2600, 7000, 13000])
def test_geometry_fits_the_card_and_covers_the_output(cc):
    g = djc._geometry(cc)
    block = g.smem + djc._DR_STAGE
    assert block <= SMEM_PER_BLOCK
    assert 4 * (block + 1024) <= SMEM_PER_SM        # four blocks an SM
    assert g.smem == (g.tr * g.tc + 8) * 4
    assert 1 <= g.warps <= 8 and g.tr == 2 * g.warps
    # the column tiles cover cc; a partial tile keeps 16-byte stores
    assert 0 < g.tc <= cc and -(-cc // g.tc) * g.tc >= cc
    assert g.tc == cc or g.tc % 4 == 0


def test_geometry_cuts_cc_13000_into_column_tiles():
    g = djc._geometry(13000)
    assert g.warps == 1 and g.tc < 13000 and -(-13000 // g.tc) >= 2


def test_geometry_keeps_whole_rows_where_they_fit():
    """synthetic-1000's widest PProg join (cc 2600) and the n = 200 refine
    half (cc 768) take one column tile; narrow joins take more warps, so
    four blocks of the tile fit an SM."""
    assert djc._geometry(2600).tc == 2600
    assert djc._geometry(768) == (8, 16, 768, (16 * 768 + 8) * 4)
    assert djc._geometry(45).warps == 8


def _store(rng, p1, l, k, full):
    """(P1, l, k) store, valid slots first, unique columns; every slot
    valid where `full`; the last row is the empty dump slot."""
    cols = np.argsort(rng.random((p1, l, l)), axis=-1)[..., :k]
    nnz = k if full else rng.integers(1, k + 1, size=(p1, l, 1))
    valid = np.broadcast_to(np.arange(k) < nnz, (p1, l, k)).copy()
    valid[-1] = False
    vals = np.where(valid, rng.random((p1, l, k)) * 0.9 + 0.02, 0.0)
    return (vals.astype(np.float32),
            np.where(valid, cols, -1).astype(np.int32))


def _entries_oracle(sv, sc, k2, entries, bank, dump, l, cc):
    """numpy: F[s] summed over owner s's (store row, col-owner) entries
    in order, each valid slot at its col-owner's column."""
    f = np.zeros((len(entries), l, cc), np.float32)
    for s, run in enumerate(entries):
        for p, t in run:
            if p == dump or not 0 <= t < len(bank):
                continue
            r, k = np.nonzero(sc[p, :, :k2] >= 0)
            col = bank[t, sc[p, r, k]]
            ok = (col >= 0) & (col < cc)
            f[s, r[ok], col[ok]] += sv[p, r[ok], k[ok]]
    return f


@pytest.mark.parametrize("full", [True, False], ids=["32-slots", "ragged"])
def test_densify_reduce_plain_full_rows_and_all_dump_owner(full):
    rng = np.random.default_rng(11)
    l, k, k2, cc, n_r, n_c, p1 = 40, 32, 32, 70, 4, 6, 12
    dump = p1 - 1
    sv, sc = _store(rng, p1, l, k, full)
    pid = rng.integers(0, dump, size=(n_r, n_c)).astype(np.int32)
    pid[1] = dump                                  # an all-dump owner
    pid[3, ::2] = dump
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n_c)]).astype(np.int32)
    got = djc.densify_reduce(*(torch.from_numpy(a) for a in (sv, sc)), k2,
                             torch.from_numpy(pid), torch.from_numpy(bank),
                             dump, cc)
    entries = [[(pid[s, t], t) for t in range(n_c)] for s in range(n_r)]
    want = _entries_oracle(sv, sc, k2, entries, bank, dump, l, cc)
    assert np.array_equal(got.numpy(), want)
    assert not got[1].any()


@pytest.mark.parametrize("full", [True, False], ids=["32-slots", "ragged"])
def test_densify_reduce_list_plain_full_rows_and_all_dump_owner(full):
    rng = np.random.default_rng(12)
    l, k, k2, cc, n_s, n2, p1 = 36, 32, 32, 55, 5, 4, 14
    dump = p1 - 1
    sv, sc = _store(rng, p1, l, k, full)
    counts = [3, 4, 0, 2, 5]                        # owner 2: no entry
    pid = rng.integers(0, dump, sum(counts)).astype(np.int32)
    pid[3:7] = dump                                 # owner 1: all dump
    co = rng.integers(0, n2, len(pid)).astype(np.int32)
    co[-1] = n2 + 2                                 # out of range: nothing
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    bank = np.stack([np.sort(rng.choice(cc, l, replace=False))
                     for _ in range(n2)]).astype(np.int32)
    got = djc.densify_reduce_list(
        *(torch.from_numpy(a) for a in (sv, sc)), k2,
        *(torch.from_numpy(a) for a in (row_ptr, pid, co, bank)), dump, cc)
    entries = [list(zip(pid[row_ptr[s]:row_ptr[s + 1]],
                        co[row_ptr[s]:row_ptr[s + 1]])) for s in range(n_s)]
    want = _entries_oracle(sv, sc, k2, entries, bank, dump, l, cc)
    assert np.array_equal(got.numpy(), want)
    assert not got[1].any() and not got[2].any()
