"""Guide-tree join order for progressive alignment.

Post-order traversal of the rooted guide tree emitting (index1, index2)
join pairs, where leaf indexes are the *sequence* indexes (label lookup)
and join k creates node leaf_count + k
(reference: src/guidetreejoinorder.cpp:103-160).
"""

from __future__ import annotations

from .tree import Tree


def guide_tree_join_order(tree: Tree, label_to_index: dict[str, int]
                          ) -> tuple[list[int], list[int]]:
    leaf_count = tree.leaf_count
    idx1: list[int] = []
    idx2: list[int] = []
    stack: list[int] = []
    join_index = leaf_count
    used = set()
    for node in tree.depth_first():
        if tree.is_leaf(node):
            label = tree.labels[node]
            if label not in label_to_index:
                raise KeyError(f"label not found in inputs: {label!r}")
            i = label_to_index[label]
            if i in used:
                raise ValueError(f"duplicate leaf {label!r}")
            used.add(i)
            stack.append(i)
        else:
            right = stack.pop()
            left = stack.pop()
            idx1.append(left)
            idx2.append(right)
            stack.append(join_index)
            join_index += 1
    validate_join_order(idx1, idx2)
    return idx1, idx2


def validate_join_order(idx1: list[int], idx2: list[int]) -> None:
    """reference: src/guidetreejoinorder.cpp:7-53 (ValidateJoinOrder)."""
    join_count = len(idx1)
    assert len(idx2) == join_count
    leaf_count = join_count + 1
    node_count = 2 * leaf_count - 1
    pending = set(range(leaf_count))
    used = [False] * node_count
    for k in range(join_count):
        i1, i2 = idx1[k], idx2[k]
        assert i1 != i2 and i1 < node_count and i2 < node_count
        assert not used[i1] and not used[i2]
        assert i1 in pending and i2 in pending
        used[i1] = used[i2] = True
        pending.discard(i1)
        pending.discard(i2)
        pending.add(leaf_count + k)
    assert len(pending) == 1
