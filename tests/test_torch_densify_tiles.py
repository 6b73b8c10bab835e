"""Kernel 8's tiles (ops/densify_cuda.py, csrc/densify.cu) on the CPU.

Kernel 8 writes each z-tile's row panel of the Gram consistency one
shared-memory tile a block: store rows [s0, s0 + R) x store columns
[c0, c0 + C) of one slab (R x itemsize = 128 bytes, at most 32 KB a
tile, `tile_shape`), written out once, transposed for FLAG_TRANS. These
tests hold what runs here: the tile shapes; that the items' output
rectangles cover every panel cell exactly once, in rows of whole
128-byte lines at the store's widths; the tiled walk
(`densify_panel_tiled_plain`, item by item as the kernel) against the
plain version `densify_panel_plain` bit for bit at L = 128, 384, 512,
1536 and 3072 in f32 and bf16, over every flag, a pid below 0 and the
dump row; and the tiled walk against the JAX package's
`_densify_rowpanel` (as tests/test_torch_consistency.py holds the plain
version). The kernel on the card: tests/test_torch_cuda_1e_densify.py.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from muscle_tpu.ops import consistency as j_cons
from muscle_tpu_torch.ops import consistency as t_cons
from muscle_tpu_torch.ops import densify_cuda as dc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WIDTHS = (128, 384, 512, 1536, 3072)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_tile_shapes():
    """R rows of one 128-byte line, C columns up to 32 KB a tile."""
    assert dc.tile_shape(512, torch.float32) == (32, 256)
    assert dc.tile_shape(512, torch.bfloat16) == (64, 256)
    assert dc.tile_shape(128, torch.bfloat16) == (64, 128)
    assert dc.tile_shape(12288, torch.float32) == (32, 256)
    for l in WIDTHS + (64, 12288):
        for dtype in DTYPES:
            r, c = dc.tile_shape(l, dtype)
            size = torch.empty((), dtype=dtype).element_size()
            assert r * size == 128 and r * c * size <= 32 * 1024


def test_tile_constants_are_the_kernels():
    """tile_shape's constants are csrc/densify.cu's, which fixes the tile
    from the dtype alone."""
    with open(os.path.join(ROOT, "muscle_tpu_torch", "csrc",
                           "densify.cu")) as f:
        src = f.read()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([0-9* ]+);", src)
        assert m, name
        return eval(m.group(1))
    assert const("kLineBytes") == dc.LINE_BYTES
    assert const("kTileBytes") == dc.TILE_BYTES


def _rectangles(l, t, nb, dtype, flags):
    """Each item's output rectangle (row0, rows, col0, cols), in the
    kernel's item order (slab, band, column tile)."""
    r, c = dc.tile_shape(l, dtype)
    out = []
    for slab in range(t * nb):
        a, b = divmod(slab, nb)
        for s0 in range(0, l, r):
            rn = min(r, l - s0)
            for c0 in range(0, l, c):
                cn = min(c, l - c0)
                if flags[a][b] == dc.FLAG_TRANS:
                    out.append((a * l + c0, cn, b * l + s0, rn))
                else:
                    out.append((a * l + s0, rn, b * l + c0, cn))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l", WIDTHS + (12288,))
def test_items_write_each_cell_once(l, dtype):
    """The items' rectangles cover the panel exactly once; at the
    store's widths (multiples of 128) every output row of an item is
    whole 128-byte lines, so no sector is written twice."""
    t, nb = 2, 3
    flags = [[dc.FLAG_EYE, dc.FLAG_STORE, dc.FLAG_STORE],
             [dc.FLAG_TRANS, dc.FLAG_EYE, dc.FLAG_STORE]]
    size = torch.empty((), dtype=dtype).element_size()
    count = np.zeros((t * l, nb * l), np.int8)
    for r0, rn, c0, cn in _rectangles(l, t, nb, dtype, flags):
        count[r0:r0 + rn, c0:c0 + cn] += 1
        assert (c0 * size) % 128 == 0 and (cn * size) % 128 == 0
    assert (count == 1).all()


def _store(rng, p1, l, k, max_row_nnz=5):
    """A (p1, l, k) store: 0..max_row_nnz valid slots a row, valid slots
    first, unique columns, values in [0.02, 0.92); the last row is the
    empty dump row."""
    cols = rng.random((p1, l, l), dtype=np.float32).argpartition(
        max_row_nnz, axis=-1)[..., :max_row_nnz].astype(np.int32)
    cnt = rng.integers(0, max_row_nnz + 1, size=(p1, l, 1))
    valid = np.arange(max_row_nnz) < cnt
    valid[-1] = False
    vals = np.zeros((p1, l, k), np.float32)
    cc = np.full((p1, l, k), -1, np.int32)
    vals[..., :max_row_nnz] = np.where(
        valid, rng.random((p1, l, max_row_nnz)) * 0.9 + 0.02, 0.0)
    cc[..., :max_row_nnz] = np.where(valid, cols, -1)
    return torch.from_numpy(vals), torch.from_numpy(cc)


def _maps(n, nbp, dump):
    """(t = 2, nbp) maps of the first z-tile of n sequences (FLAG_EYE,
    FLAG_STORE, FLAG_TRANS, dump columns past n) with one pid set below
    0."""
    pid, flag = t_cons._block_maps(n, nbp, dump)
    pid = pid[:2].copy()
    pid[1, -1] = -1
    return torch.from_numpy(pid), torch.from_numpy(flag[:2].copy())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("l", WIDTHS)
def test_tiled_walk_equals_plain(l, dtype):
    """The kernel's walk, item by item, gives densify_panel_plain's
    panel bit for bit: every flag, a pid below 0, the dump row."""
    rng = np.random.default_rng(l)
    n, nbp = 3, 5
    p1 = n * (n - 1) // 2 + 1
    vals, cols = _store(rng, p1, l, 8)
    pids, flags = _maps(n, nbp, p1 - 1)
    assert set(flags.reshape(-1).tolist()) == {dc.FLAG_STORE, dc.FLAG_TRANS,
                                               dc.FLAG_EYE}
    assert (pids == p1 - 1).any() and (pids < 0).any()
    want = dc.densify_panel_plain(vals, cols, pids, flags, dtype)
    got = dc.densify_panel_tiled_plain(vals, cols, pids, flags, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(dc.densify_panel(vals, cols, pids, flags, dtype), want)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tiled_walk_matches_jax_rowpanel(bf16):
    """The tiled walk writes the JAX package's _densify_rowpanel panel
    (orientation flags, dtype) bit for bit, z-tile by z-tile."""
    rng = np.random.default_rng(15)
    n, l, k, blk, nbp = 9, 128, 8, 4, 12
    p1 = n * (n - 1) // 2 + 1
    vals, cols = _store(rng, p1, l, k)
    pid, flag = j_cons._block_maps(n, nbp, p1 - 1)
    dtype = torch.bfloat16 if bf16 else torch.float32
    for zi in range(-(-n // blk)):
        zs = slice(zi * blk, (zi + 1) * blk)
        want = j_cons._densify_rowpanel(
            jnp.asarray(vals.numpy()), jnp.asarray(cols.numpy()),
            jnp.asarray(pid[zs]), jnp.asarray(flag[zs]), t=blk, l=l,
            mode="scatter", bf16=bf16, cb=1)
        got = dc.densify_panel_tiled_plain(
            vals, cols, torch.from_numpy(pid[zs]), torch.from_numpy(flag[zs]),
            dtype)
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))
