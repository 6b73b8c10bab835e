"""Clustal sequence weights from the guide tree.

Host copy of muscle_tpu.tree.clustalweights (numpy only).

reference: src/clustalweights.cpp:4-76. Weight of a leaf = sum over its
root path of edge_length / subtree_leaf_count (edge lengths clamped to
>= 0.05), normalized to sum 1. Note: MPCFlat computes these but then
overrides them to 1.0 (src/mpcflat.cpp:316-326 '@@@@ TODO'); we do the
same in the pipeline and expose the computation for API parity and
future use.
"""

from __future__ import annotations

import numpy as np

from .tree import Tree


def clustal_weights(tree: Tree, labels: list[str]) -> np.ndarray:
    """Per-sequence weights in `labels` order; sums to 1."""
    sizes = tree.subtree_leaf_counts()
    n_nodes = tree.node_count
    strength = np.zeros(n_nodes, dtype=np.float64)
    for node in range(n_nodes):
        if node == tree.root:
            continue
        length = max(float(tree.length[node]), 0.05)
        strength[node] = length / sizes[node]

    label_to_idx = {lb: i for i, lb in enumerate(labels)}
    weights = np.zeros(len(labels), dtype=np.float64)
    for node in range(n_nodes):
        if not tree.is_leaf(node):
            continue
        w = 0.0
        cur = node
        while cur != tree.root:
            w += strength[cur]
            cur = tree.parent[cur]
        weights[label_to_idx[tree.labels[node]]] = w
    total = weights.sum()
    if total > 0:
        weights /= total
    else:
        weights[:] = 1.0 / len(labels)
    return weights.astype(np.float32)
