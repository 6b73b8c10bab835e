"""Super4's per-cluster MPCs.

Port of muscle_tpu.pipeline.cluster_batch.run_clusters_batched by its
contract. The JAX package packs many small clusters' pair grids into
one dispatch because each dispatch costs a TPU round trip; its
docstring and tests/test_cluster_batch.py hold the batched result
bit-identical to the serial loop `mpc_factory().run(sub, hp, alpha)`
with singletons passed through. That serial loop is what runs here;
batching clusters on the card is a later speed question.
"""

from __future__ import annotations

from ..hmm.params import HMMParams
from ..sequence import MultiSequence


def run_clusters_batched(subs, hp: HMMParams, alpha: str, mpc_factory
                         ) -> list[MultiSequence]:
    """Align each MultiSequence in `subs`; returns MSAs in input order
    (singletons pass through unchanged, as in Super4)."""
    return [sub if len(sub) == 1 else mpc_factory().run(sub, hp, alpha)
            for sub in subs]
