"""The sharded paths of muscle_tpu_torch at a tiny size, for
tests/test_torch_parallel.py.

`run_cases(workdir)` drives every path that parallel/mesh.py shards,
through the port's own entry points, in whatever world the process is
in: the test's own process runs it as a world of one (no process
group), and two ranks of a gloo process group run it as

    python tests/torch_parallel_cases.py INIT_FILE RANK WORLD WORKDIR

each writing its results to WORKDIR/rank<RANK>.pkl. Everything here
imports muscle_tpu_torch and nothing of JAX, so the ranks never load it.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from muscle_tpu_torch import MultiSequence, Sequence  # noqa: E402

AMINO = b"ACDEFGHIKLMNPQRSTVWY"


def family(lengths, seed):
    """Mutated copies of one random protein, of the given lengths."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 20, size=max(lengths))
    seqs = MultiSequence()
    for i, ln in enumerate(lengths):
        mut = base[:ln].copy()
        pos = rng.integers(0, ln, size=ln // 4)
        mut[pos] = rng.integers(0, 20, size=pos.size)
        seqs.add(Sequence(f"s{i}", bytes(AMINO[c] for c in mut)))
    return seqs


@contextlib.contextmanager
def sparse_branch():
    """Families past the dense small-family branch take the bucketed
    store and the Gram consistency (as they do past n * L = 16384)."""
    from muscle_tpu_torch.pipeline import posteriors
    saved = posteriors.SMALL_DENSE_NL
    posteriors.SMALL_DENSE_NL = 0
    try:
        yield
    finally:
        posteriors.SMALL_DENSE_NL = saved


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def run_cases(workdir: str) -> dict:
    """{case: numpy arrays, ints or text} of every sharded path."""
    from muscle_tpu_torch import align
    from muscle_tpu_torch.cli import main as cli_main
    from muscle_tpu_torch.hmm.params import HMMParams
    from muscle_tpu_torch.io.mega import parse_mega
    from muscle_tpu_torch.ops.consistency import consistency_sparse
    from muscle_tpu_torch.ops.emissions import pad_profiles
    from muscle_tpu_torch.parallel.mesh import make_mesh
    from muscle_tpu_torch.pipeline import posteriors as post
    from mega_synth import mega_text

    dev = torch.device("cpu")
    mesh = make_mesh()
    out = {}

    # two length buckets (128 and the pad, 170), each one chunk of the
    # store; the EA-only pass's chunks (real pairs only) of 10 and 5
    # pairs, the latter split unevenly
    seqs = family([30, 40, 50, 60, 70, 170], 3)
    codes, lens = post.encode_batch(seqs, "ACDEFGHIKLMNPQRSTVWY")
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    pack = HMMParams.from_defaults().to_scores()
    hp = HMMParams.from_defaults()
    hp.perturb(7)
    packs = [pack, hp.to_scores()]

    _, ea = post.all_pairs_posteriors(codes, lens, pack, pairs, dev,
                                      batch_size=16, return_post=False)
    out["ea_only"] = ea
    # the dense return: chunks of 2 and 1 pairs
    p_dense, ea_dense = post.all_pairs_posteriors(
        codes[:3, :50], lens[:3], pack, [(0, 1), (2, 0), (1, 2)], dev,
        batch_size=2)
    out["dense"] = (p_dense, ea_dense)
    vals, cols, ea, nnz = post.all_pairs_posteriors_sparse(
        codes, lens, pack, pairs, dev, batch_size=16, k=8)
    out["sparse_store"] = (_np(vals), _np(cols), ea, nnz)
    vals, cols, ea, nnz = post.ensemble_pairs_posteriors_sparse(
        codes, lens, packs, pairs, dev, batch_size=32, k=8)
    out["ensemble_store"] = (_np(vals), _np(cols), ea, nnz)

    ms = parse_mega(mega_text(4, 30, 60, 21))
    profiles = pad_profiles(ms.profiles, 64)
    mlens = np.array([p.shape[0] for p in ms.profiles], np.int32)
    mpairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    vals, cols, ea, nnz = post.small_family_store(
        profiles, mlens, pack, mpairs, 4, 8, 2, dev, mega=ms)
    out["mega_small_family"] = (_np(vals), _np(cols), ea, nnz)
    vals, cols, ea, nnz = post.all_pairs_posteriors_mega_sparse(
        profiles, mlens, ms, pack, mpairs, dev, batch_size=4, k=8)
    out["mega_store"] = (_np(vals), _np(cols), ea, nnz)

    with np.load(os.path.join(workdir, "cons_store.npz")) as z:
        sv, sc, n = torch.from_numpy(z["vals"]), torch.from_numpy(z["cols"]), \
            int(z["n"])
    out["consistency"] = _np(consistency_sparse(sv, sc, n, 2, seq_block=4,
                                                mesh=mesh))

    small = family([30, 38, 45, 50, 41], 5)
    fa = os.path.join(workdir, "small.fa")
    if mesh.rank == 0:
        small.write_fasta(fa + f".{os.getpid()}")
        os.replace(fa + f".{os.getpid()}", fa)
    with sparse_branch():
        msa = align(small, device=dev, refine_iters=4)
        out["align"] = "".join(f">{s.label}\n{s.text()}\n" for s in msa)
        if mesh.group is not None:
            torch.distributed.barrier()    # rank 0 has written the input
        afa = os.path.join(workdir, f"cli.rank{mesh.rank}.afa")
        rc = cli_main(["-align", fa, "-output", afa, "-refineiters", "4",
                       "-device", "cpu", "-quiet"])
    out["cli_rc"] = rc
    out["cli_wrote"] = os.path.exists(afa)
    if out["cli_wrote"]:
        with open(afa) as f:
            out["cli"] = f.read()
    return out


def main(init_file: str, rank: int, world: int, workdir: str) -> int:
    from muscle_tpu_torch.parallel.mesh import init_distributed, shutdown
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    mesh = init_distributed(f"file://{init_file}", world, rank,
                            backend="gloo", device="cpu")
    assert mesh.world == world and mesh.rank == rank
    try:
        out = run_cases(workdir)
    finally:
        shutdown()
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "jaxlib", "muscle_tpu"))
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4]))
