"""Random caterpillar ("chain") guide tree for ablations.

Host copy of muscle_tpu.tree.randomchain (numpy only).

reference: src/randomchaintree.cpp — shuffle the leaf order with the
global MWC RNG, then chain joins: (s0, s1), (join0, s2), ...
Used by -randomchaintree to measure how much the guide tree matters.
"""

from __future__ import annotations

from ..utils.rng import MwcRng
from .tree import Tree


def random_chain_tree(labels: list[str], rng: MwcRng | None = None) -> Tree:
    n = len(labels)
    order = list(range(n))
    (rng or MwcRng(1)).shuffle(order)
    lefts = []
    rights = []
    for i in range(n - 1):
        if i == 0:
            lefts.append(order[0])
            rights.append(order[1])
        else:
            lefts.append(n + i - 1)
            rights.append(order[i + 1])
    return Tree.from_joins(labels, lefts, rights)
