"""The sparsify's top-K kernel (csrc/sparsify_topk.cu) on the card.

Each case holds the kernel to the plain version (a stable sort of each
row, ops/sparse.py::sparsify_plain) on the same CUDA tensor, bit for bit:
values, columns and the row-nnz max. This file imports neither jax nor
muscle_tpu:

    MUSCLE_TPU_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_cuda_topk.py

The same kernel against lax.top_k's order on the CPU (through the plain
version and the kernel's schedule model): tests/test_torch_sparse_topk.py.
"""

import numpy as np
import pytest
import torch

from muscle_tpu_torch.ops import sparse as sp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel builds with nvcc)")
    return torch.device("cuda")


def _assert_equal(post, k, **kw):
    torch.cuda.synchronize()
    before = sp.LAUNCHES["sparsify_topk"]
    v, c, n = sp.sparsify_topk(post, k, **kw)
    torch.cuda.synchronize()
    assert sp.LAUNCHES["sparsify_topk"] == before + 1
    wv, wc, wn = sp.sparsify_plain(post, k)
    assert torch.equal(v, wv) and torch.equal(c, wc)
    assert int(n) == int(wn)


def _sparse_post(shape, density, seed, device, values=None):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 1.0, size=shape).astype(np.float32)
    if values is not None:
        p = rng.choice(np.float32(values), size=shape)
    p[rng.uniform(size=shape) >= density] = 0
    return torch.as_tensor(p, device=device)


def _counted_rows(k, ly, seed, device):
    """Rows of exactly 0, K, K + 1 and 4K entries > 0, ties among them."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((8, ly), np.float32)
    for r, n in enumerate((0, k, k + 1, 4 * k) * 2):
        at = rng.choice(ly, size=min(n, ly), replace=False)
        vals = (np.float32([0.25, 0.5]) if r >= 4
                else rng.uniform(0.01, 1, size=len(at)).astype(np.float32))
        rows[r, at] = rng.choice(vals, size=len(at)) if r >= 4 else vals
    return torch.as_tensor(rows[None], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 32, 56])
@pytest.mark.parametrize("ly", [512, 12288, 300, 301])
def test_counted_rows(cuda_device, k, ly):
    """Rows of 0, K, K + 1 and 4K entries at K = 16, 32, 56, on 16-byte
    steps (512, 12288; 300 with a ragged last step) and one column a lane
    (301)."""
    _assert_equal(_counted_rows(k, ly, k + ly, cuda_device), k)


@pytest.mark.cuda
@pytest.mark.parametrize("k,stripes", [(56, 1), (100, 1), (300, 8),
                                       (16, 8), (1, 1)])
def test_passes_and_stripes(cuda_device, k, stripes):
    """K past 32 * S (more passes over each row) and more stripes than K
    needs, on rows with many ties."""
    post = _sparse_post((4, 64, 1024), 0.4, k, cuda_device,
                        values=[0.25, 0.5, 0.75])
    _assert_equal(post, k, stripes=stripes)


@pytest.mark.cuda
def test_main_path_shapes(cuda_device):
    """512 pairs at 512^2 (a sparse posterior as kernel B writes), a
    tie-heavy one, a transposed view (the router's swapped pairs, read
    through strides) and a row slice at an odd width (the scan route)."""
    post = _sparse_post((512, 512, 512), 0.012, 1, cuda_device)
    _assert_equal(post, 32)
    ties = _sparse_post((64, 512, 512), 0.25, 2, cuda_device,
                        values=[0.25, 0.5])
    _assert_equal(ties, 32)
    _assert_equal(ties[:8].transpose(1, 2), 32)
    _assert_equal(ties[:1, :200, :509], 16)


@pytest.mark.cuda
def test_wide_chunk_pair_by_pair(cuda_device):
    """One pair of a 16384-wide chunk, and the kernel's range."""
    post = _sparse_post((1, 2048, 16384), 0.0005, 3, cuda_device)
    _assert_equal(post, 32)
    with pytest.raises(ValueError, match="lax.top_k"):
        sp.sparsify_topk(post[:, :, :8], 32)
