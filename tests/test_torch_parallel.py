"""muscle_tpu_torch/parallel/mesh.py: the pair grid and the Gram
consistency sharded over a torch.distributed process group, on the CPU.

* The port's chunk granularity equals the JAX package's for every
  backend and device count.
* The port's sharded_batch_posteriors (a world of one) against the JAX
  package's on a two-device mesh, on the same batch: posterior and EA
  within 1e-5 (the scan-against-scan tolerance of
  tests/test_torch_pairhmm.py).
* One spawn of two gloo ranks (tests/torch_parallel_cases.py, which
  imports nothing of JAX) runs every sharded path; each rank's results
  must equal this process's world of one bit for bit: the EA-only pass,
  the dense return, the bucketed store, the ensembles' stream of two
  packs, a `.mega` small family and a `.mega` store, the consistency
  with `mesh=`, align() of a tiny family and the CLI's -align, whose
  file only rank 0 writes. The ranks' sharded consistency is also held
  to the JAX package's on a two-device mesh within 1e-6, on
  tests/test_consistency.py's sharded store, as that test holds it.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_parallel_cases as cases  # noqa: E402
from test_consistency import _random_sparse_posts  # noqa: E402
from test_torch_pairhmm import _batch, _jax_pack, _port_pack  # noqa: E402

RANK_TIMEOUT_S = 120
WORLD = 2
CASES = ("ea_only", "dense", "sparse_store", "ensemble_store",
         "mega_small_family", "mega_store", "consistency", "align")


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("port,jax_backend", [("cuda", "pallas"),
                                              ("scan", "scan")])
def test_chunk_step_matches_jax(port, jax_backend, n_dev):
    from muscle_tpu.pipeline import posteriors as j_post
    from muscle_tpu_torch.pipeline import posteriors as t_post
    assert t_post._chunk_step(port, n_dev) == \
        j_post._chunk_step(jax_backend, n_dev)


def test_sharded_batch_posteriors_matches_jax():
    from muscle_tpu.parallel import mesh as j_mesh
    from muscle_tpu_torch.parallel import mesh as t_mesh
    xb, yb, lx, ly = _batch(4, 48, 3, False, lane_pad=False)
    jp = _jax_pack(False)
    j_fn = j_mesh.sharded_batch_posteriors(
        j_mesh.make_mesh(jax.devices()[:2]), jp, backend="scan")
    post_j, ea_j = j_fn(*(jnp.asarray(a) for a in (xb, yb, lx, ly)))
    mesh = t_mesh.make_mesh()
    assert mesh.world == 1 and mesh.group is None
    t_fn = t_mesh.sharded_batch_posteriors(mesh, _port_pack(jp),
                                           backend="scan")
    post_t, ea_t = t_fn(*(torch.from_numpy(a) for a in (xb, yb, lx, ly)))
    assert float(np.max(np.abs(np.asarray(post_j) - post_t.numpy()))) < 1e-5
    assert float(np.max(np.abs(np.asarray(ea_j) - ea_t.numpy()))) < 1e-5


def test_batch_spec_and_global_array():
    from muscle_tpu_torch.parallel.mesh import (Mesh, batch_spec,
                                                global_array)
    value = np.arange(12).reshape(6, 2)
    shards = [global_array(Mesh(3, r, torch.device("cpu")), value)
              for r in range(3)]
    assert [batch_spec(Mesh(3, r, torch.device("cpu")), 6) for r in
            range(3)] == [slice(0, 2), slice(2, 4), slice(4, 6)]
    assert np.array_equal(torch.cat(shards).numpy(), value)
    with pytest.raises(ValueError):
        batch_spec(Mesh(4, 0, torch.device("cpu")), 6)


def test_no_launcher_no_group(monkeypatch):
    """Without torchrun's environment init_distributed does nothing and
    the mesh is a world of one with no group (nothing sharded)."""
    from muscle_tpu_torch.parallel import mesh as t_mesh
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert t_mesh.init_distributed() is None
    mesh = t_mesh.make_mesh()
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    fn = lambda *a: a  # noqa: E731
    assert t_mesh.shard_lanes(mesh, fn) is fn
    two = t_mesh.make_mesh_2d()
    assert two.axis_names == ("nodes", "per_node") and two.shape == (1, 1)


def test_chunk_pairs_pins_launch_shapes():
    """Inside chunk_pairs(b) the launch shapes that B enters are picked
    for b: kernel 3K's schedule and kernel 4's warps differ between a
    chunk of 256 lanes and a rank's 64 of them at these widths."""
    from muscle_tpu_torch.ops import pairhmm_cuda as pc
    from muscle_tpu_torch.ops import pairhmm_emis_cuda as pe
    from muscle_tpu_torch.ops import wavefront
    assert pc.bwd_codes_geometry(64, 1024) != pc.bwd_codes_geometry(256,
                                                                    1024)
    assert pe.mea_scores_warps(64, 1024) != pe.mea_scores_warps(256, 1024)
    assert wavefront.geometry_pairs(64) == 64
    with wavefront.chunk_pairs(256):
        assert wavefront.geometry_pairs(64) == 256
        with wavefront.chunk_pairs(8):
            assert wavefront.geometry_pairs(64) == 8
        assert wavefront.geometry_pairs(64) == 256
    assert wavefront.geometry_pairs(64) == 64


def test_group_of_one_runs_collectives(tmp_path):
    """A process group of one still shards (every collective runs): a
    chunk's outputs and the consistency equal the unsharded ones."""
    from muscle_tpu_torch.ops import wavefront
    from muscle_tpu_torch.ops.consistency import consistency_sparse
    from muscle_tpu_torch.parallel import mesh as t_mesh
    mesh = t_mesh.init_distributed(f"file://{tmp_path / 'init'}", 1, 0,
                                   backend="gloo", device="cpu")
    try:
        assert mesh.world == 1 and mesh.group is not None
        t_mesh.reset_counts()
        seen = []

        def fn(x, y):
            seen.append((x.shape[0], wavefront.geometry_pairs(x.shape[0])))
            return x * 2, None, y + 1

        x = torch.arange(15.0).reshape(5, 3)
        y = torch.arange(5, dtype=torch.int32)
        a, none, b = t_mesh.shard_lanes(mesh, fn)(x, y)
        assert seen == [(5, 5)] and none is None
        assert torch.equal(a, x * 2) and torch.equal(b, y + 1)
        assert t_mesh.COUNTS["chunks"] == 1 and t_mesh.COUNTS["gathers"] == 2
        vals, cols, n = _cons_store()
        sv, sc = torch.from_numpy(vals), torch.from_numpy(cols)
        one = consistency_sparse(sv, sc, n, 2, seq_block=4, mesh=mesh)
        assert t_mesh.COUNTS["sums"] == 2
        assert torch.equal(one, consistency_sparse(sv, sc, n, 2,
                                                   seq_block=4))
    finally:
        t_mesh.shutdown()
    assert t_mesh.make_mesh().group is None


def _cons_store():
    """tests/test_consistency.py's sharded case: n = 9, l = 32, k = 8."""
    from muscle_tpu.ops import sparse as sp
    rng = np.random.default_rng(9)
    n, l, k = 9, 32, 8
    _, post = _random_sparse_posts(rng, n, l, max_row_nnz=4)
    vals, cols, _ = sp.sparsify(jnp.asarray(post), k)
    vals = np.concatenate([np.asarray(vals), np.zeros((1, l, k), np.float32)])
    cols = np.concatenate([np.asarray(cols),
                           np.full((1, l, k), -1, np.int32)])
    return vals, cols, n


def _jax_sharded_consistency(vals, cols, n):
    from muscle_tpu.ops import consistency as j_cons
    from muscle_tpu.parallel.mesh import make_mesh
    return np.asarray(j_cons.consistency_sparse(
        jnp.asarray(vals), jnp.asarray(cols), n, 2, seq_block=4,
        mesh=make_mesh(jax.devices()[:2])))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(this process's world of one, [each rank's results]) of one spawn
    of two gloo ranks, and the JAX package's sharded consistency on the
    ranks' store (computed while they run)."""
    work = str(tmp_path_factory.mktemp("world2"))
    vals, cols, n = _cons_store()
    np.savez(os.path.join(work, "cons_store.npz"), vals=vals, cols=cols, n=n)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    init = os.path.join(work, "init")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_cases.py"),
         init, str(r), str(WORLD), work], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = cases.run_cases(work)
        want_cons = _jax_sharded_consistency(vals, cols, n)
    finally:
        torch.set_num_threads(threads)
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"a rank ran past {RANK_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    got = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return one, got, want_cons


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return a == b


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(ranks, case):
    one, got, _ = ranks
    for r in range(WORLD):
        assert _same(one[case], got[r][case]), f"rank {r}: {case}"


def test_ranks_load_no_jax(ranks):
    _, got, _ = ranks
    for r in range(WORLD):
        assert got[r]["jax_modules"] == [], got[r]["jax_modules"]


def test_cli_only_rank0_writes(ranks):
    one, got, _ = ranks
    assert one["cli_rc"] == 0 and one["cli_wrote"]
    assert [g["cli_rc"] for g in got] == [0] * WORLD
    assert got[0]["cli_wrote"] and got[0]["cli"] == one["cli"]
    assert not any(g["cli_wrote"] for g in got[1:])
    # the CLI's alignment is align()'s
    assert one["cli"] == one["align"]


def test_sharded_consistency_matches_jax(ranks):
    _, got, want = ranks
    for r in range(WORLD):
        assert np.abs(want[:-1] - got[r]["consistency"][:-1]).max() < 1e-6
