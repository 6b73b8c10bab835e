"""Guide-tree permutations ABC/ACB/BCA for ensemble diversity.

reference: src/permutetree.cpp:24-139 — split the tree into A (~1/3 of
leaves), then B, C (~half of the rest each); rebuild as ((A,B),C),
((A,C),B) or ((B,C),A) with fresh 0.1-length edges; no-op under 10
leaves.
"""

from __future__ import annotations

from .tree import Tree

TREE_PERMS = ("none", "abc", "acb", "bca")


def _divide_fraction(tree: Tree, fract: float) -> tuple[Tree, Tree]:
    """Split at the node whose subtree leaf count is closest to
    fract * leaf_count (first best in node order wins;
    reference: src/dividetree.cpp DivideTreeFraction)."""
    n_leaves = tree.leaf_count
    target = max(1, int(n_leaves * fract + 0.5))
    counts = tree.subtree_leaf_counts()
    best_node, best_diff = None, None
    for node in range(tree.node_count):
        c = counts.get(node)
        if c is None or c == n_leaves:
            continue
        diff = abs(c - target)
        if best_diff is None or diff < best_diff:
            best_node, best_diff = node, diff
    return _divide(tree, best_node)


def _subtree(tree: Tree, node: int) -> Tree:
    labels = tree.subtree_leaves(node)
    return _tree_from_labels(tree, node, labels)


def _tree_from_labels(tree: Tree, root: int, labels: list[str]) -> Tree:
    # rebuild the subtree structure rooted at `root`
    lefts, rights = [], []
    leaf_ids: dict[int, int] = {}
    leaf_labels: list[str] = []

    def rec(node: int) -> int:
        if tree.is_leaf(node):
            leaf_labels.append(tree.labels[node])
            return len(leaf_labels) - 1
        l = rec(tree.left[node])
        r = rec(tree.right[node])
        lefts.append(l)
        rights.append(r)
        return -len(lefts)  # placeholder, fixed after n known

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * tree.node_count + 100))
    try:
        rec(root)
    finally:
        sys.setrecursionlimit(old)
    n = len(leaf_labels)
    fix = lambda v: v if v >= 0 else n + (-v) - 1
    lefts = [fix(v) for v in lefts]
    rights = [fix(v) for v in rights]
    return Tree.from_joins(leaf_labels, lefts, rights)


def _divide(tree: Tree, node: int) -> tuple[Tree, Tree]:
    sub = _subtree(tree, node)
    sub_set = set(sub.leaf_labels())
    rest = [lb for lb in tree.leaf_labels() if lb not in sub_set]
    super_tree = _prune_to(tree, rest)
    return sub, super_tree


def _prune_to(tree: Tree, keep_labels: list[str]) -> Tree:
    keep = set(keep_labels)

    def rec(node: int):
        if tree.is_leaf(node):
            return node if tree.labels[node] in keep else None
        l = rec(tree.left[node])
        r = rec(tree.right[node])
        if l is None:
            return r
        if r is None:
            return l
        return (l, r)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * tree.node_count + 100))
    try:
        spec = rec(tree.root)
    finally:
        sys.setrecursionlimit(old)

    lefts, rights, leaf_labels = [], [], []

    def build(s) -> int:
        if isinstance(s, tuple):
            l = build(s[0])
            r = build(s[1])
            lefts.append(l)
            rights.append(r)
            return -len(lefts)
        leaf_labels.append(tree.labels[s])
        return len(leaf_labels) - 1

    try:
        sys.setrecursionlimit(max(old, 4 * tree.node_count + 100))
        build(spec)
    finally:
        sys.setrecursionlimit(old)
    n = len(leaf_labels)
    fix = lambda v: v if v >= 0 else n + (-v) - 1
    return Tree.from_joins(leaf_labels, [fix(v) for v in lefts],
                           [fix(v) for v in rights])


def _join(t1: Tree, t2: Tree) -> Tree:
    l1 = t1.leaf_labels()
    l2 = t2.leaf_labels()
    labels = l1 + l2

    def shift(t: Tree, leaf_off: int, join_off: int, n_total: int):
        out_l, out_r = [], []
        n = t.leaf_count
        for k in range(n - 1):
            node = n + k

            def m(v):
                return v + leaf_off if v < n else n_total + join_off + (v - n)
            out_l.append(m(t.left[node]))
            out_r.append(m(t.right[node]))
        return out_l, out_r

    n_total = len(labels)
    if t1.leaf_count == 1:
        j1l, j1r = [], []
    else:
        j1l, j1r = shift(t1, 0, 0, n_total)
    off2 = len(j1l)
    if t2.leaf_count == 1:
        j2l, j2r = [], []
    else:
        j2l, j2r = shift(t2, len(l1), off2, n_total)
    lefts = j1l + j2l
    rights = j1r + j2r
    # root joins the two subtree roots
    r1 = 0 if t1.leaf_count == 1 else n_total + len(j1l) - 1
    r2 = len(l1) if t2.leaf_count == 1 else n_total + off2 + len(j2l) - 1
    lefts.append(r1)
    rights.append(r2)
    return Tree.from_joins(labels, lefts, rights)


def perm_tree(tree: Tree, perm: str) -> Tree:
    perm = perm.lower()
    if perm in ("none", ""):
        return tree
    if tree.leaf_count < 10:     # reference: src/permutetree.cpp:110-112
        return tree
    a, bc = _divide_fraction(tree, 0.33)
    b, c = _divide_fraction(bc, 0.5)
    if perm == "abc":
        return _join(_join(a, b), c)
    if perm == "acb":
        return _join(_join(a, c), b)
    if perm == "bca":
        return _join(_join(b, c), a)
    raise ValueError(f"unknown tree permutation {perm!r}")
