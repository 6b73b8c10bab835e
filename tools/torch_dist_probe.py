"""The sharded paths (muscle_tpu_torch/parallel/mesh.py) on several cards.

    python -m torch.distributed.run --nproc-per-node 4 tools/torch_dist_probe.py

One rank a card. Each rank first runs chip_smoke.dist_runs (align() of
the synthetic n = 24 family at 700-1000, of mega-8 and run_align_command
of BB11001 under -diversified -replicates 4, and consistency_sparse on
the n = 24 store) with no process group on its own card, then joins the
NCCL group on cuda:LOCAL_RANK and runs them again, each chunk's lanes
now dealt over the cards; every text's, store's and consistency's
sha256 must equal the run with no group's. Then, in the group, the
CLI's -align of the n = 24 family (muscle_tpu_torch.cli.main, as the
launcher runs it): rank 0's file must be align()'s text with no group,
and no other rank may write one. Rank 0 prints each run's walls, chunks
and bytes gathered, then the card line. Exits non-zero on any
difference (a rank that fails stops the launcher's group).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    import chip_smoke as cs
    from muscle_tpu_torch import MultiSequence
    from muscle_tpu_torch.cli import main as cli_main
    from muscle_tpu_torch.io.mega import write_mega
    from muscle_tpu_torch.parallel import mesh as pm
    if not torch.cuda.is_available():
        print("torch_dist_probe: no CUDA device", file=sys.stderr)
        return 1
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix=f"dist_probe_{local}_",
                               dir=os.path.join(ROOT, "build", "chip_smoke"))
    try:
        ms, _ = cs.mega_set(*cs.MEGA_8, where=workdir)
        write_mega(ms, os.path.join(workdir, "mega-8.mega"))
        MultiSequence.from_fasta(os.path.join(ROOT, cs.FAMILIES[0][1]),
                                 strip_gaps=True).write_fasta(
            os.path.join(workdir, "BB11001.fa"))
        alone = cs.dist_runs(dev, workdir)
        t0 = time.perf_counter()
        mesh = pm.init_distributed()
        joined = time.perf_counter() - t0
        try:
            group = cs.dist_runs(dev, workdir)
            if mesh.rank == 0:
                print(cs.card_line(), flush=True)
                cs.print_dist("no process group", alone)
            cs.print_dist(f"NCCL world of {mesh.world}, rank {mesh.rank} "
                          f"(joined in {joined:.2f}s)", group, alone)
            fa = os.path.join(workdir, "n24.fa")
            cs.synthetic_family(24, 700, 1000, seed=24).write_fasta(fa)
            out = os.path.join(workdir, "n24.afa")
            t0 = time.perf_counter()
            rc = cli_main(["-align", fa, "-output", out, "-quiet"])
            wall = time.perf_counter() - t0
            wrote = os.path.exists(out)
            if rc != 0 or wrote != (mesh.rank == 0):
                raise cs.SmokeFailure(f"rank {mesh.rank}: -align rc={rc}, "
                                      f"wrote a file: {wrote}")
            if wrote:
                with open(out, "rb") as f:
                    got = hashlib.sha256(f.read()).hexdigest()
                want = alone["synthetic n=24 L=700-1000"]["text"]
                if got != want:
                    raise cs.SmokeFailure("-align in the group differs from "
                                          "align() with no group")
                print(f"NCCL world of {mesh.world}: the CLI's -align of the "
                      f"n = 24 family wall={wall:.2f}s, rank 0's file = "
                      f"align() with no group (sha256 {got[:16]}), no other "
                      "rank wrote one", flush=True)
            torch.distributed.barrier()
        finally:
            pm.shutdown()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
