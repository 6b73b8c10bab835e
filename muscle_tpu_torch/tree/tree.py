"""Rooted binary guide tree with Newick I/O.

Host-side combinatorics (reference: src/tree.{h,cpp} ~1500 LoC; we keep
only the operations the pipelines use: creation from join arrays, DFS in
the reference's order, Newick parse/serialize, subtree ops for
permutation/shrubs).

Node numbering convention matches the reference guide-tree convention:
leaves are 0..N-1, internal nodes N..2N-2, root is the last-created
internal node.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Tree:
    # per-node arrays, length 2N-1 (leaves first)
    left: list[int]
    right: list[int]
    parent: list[int]
    length: list[float]          # branch length to parent
    labels: list[str | None]     # leaf labels (None for internal)
    root: int

    # -- basics ----------------------------------------------------------
    @property
    def node_count(self) -> int:
        return len(self.left)

    @property
    def leaf_count(self) -> int:
        return (self.node_count + 1) // 2

    def is_leaf(self, node: int) -> bool:
        return self.left[node] < 0

    def leaf_labels(self) -> list[str]:
        return [self.labels[n] for n in self.depth_first()
                if self.is_leaf(n)]

    # -- construction ----------------------------------------------------
    @classmethod
    def from_joins(cls, leaf_labels: list[str], lefts, rights,
                   left_lengths=None, right_lengths=None) -> "Tree":
        """Build from UPGMA-style join arrays.

        lefts[k]/rights[k] are the child node ids of internal node
        N + k (leaf ids < N). The last join is the root
        (reference: Tree::Create as called from src/upgma5.cpp:330).
        """
        n = len(leaf_labels)
        total = 2 * n - 1
        left = [-1] * total
        right = [-1] * total
        parent = [-1] * total
        length = [0.0] * total
        labels: list[str | None] = list(leaf_labels) + [None] * (n - 1)
        for k in range(n - 1):
            node = n + k
            l, r = int(lefts[k]), int(rights[k])
            left[node] = l
            right[node] = r
            parent[l] = node
            parent[r] = node
            if left_lengths is not None:
                length[l] = float(left_lengths[k])
            if right_lengths is not None:
                length[r] = float(right_lengths[k])
        return cls(left, right, parent, length, labels, total - 1)

    # -- traversal (reference order: src/tree.cpp:760-819) ---------------
    def first_depth_first(self) -> int:
        node = self.root
        while not self.is_leaf(node):
            node = self.left[node]
        return node

    def next_depth_first(self, node: int) -> int | None:
        if node == self.root:
            return None
        p = self.parent[node]
        if self.right[p] == node:
            return p
        node = self.right[p]
        while not self.is_leaf(node):
            node = self.left[node]
        return node

    def depth_first(self):
        """Post-order traversal: left subtree, right subtree, node."""
        node = self.first_depth_first()
        while node is not None:
            yield node
            node = self.next_depth_first(node)

    def subtree_leaf_count(self, node: int) -> int:
        counts = {}
        for n in self.depth_first():
            if self.is_leaf(n):
                counts[n] = 1
            else:
                counts[n] = counts[self.left[n]] + counts[self.right[n]]
        return counts[node]

    def subtree_leaf_counts(self) -> dict[int, int]:
        counts: dict[int, int] = {}
        for n in self.depth_first():
            if self.is_leaf(n):
                counts[n] = 1
            else:
                counts[n] = counts[self.left[n]] + counts[self.right[n]]
        return counts

    def subtree_leaves(self, node: int) -> list[str]:
        out = []
        stack = [node]
        while stack:
            n = stack.pop()
            if self.is_leaf(n):
                out.append(self.labels[n])
            else:
                stack.append(self.right[n])
                stack.append(self.left[n])
        return out

    # -- newick ----------------------------------------------------------
    def to_newick(self) -> str:
        def rec(node: int) -> str:
            if self.is_leaf(node):
                name = _quote_newick(self.labels[node])
                return f"{name}:{self.length[node]:.5g}"
            s = f"({rec(self.left[node])},{rec(self.right[node])})"
            if node == self.root:
                return s
            return f"{s}:{self.length[node]:.5g}"
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * self.node_count + 100))
        try:
            return rec(self.root) + ";"
        finally:
            sys.setrecursionlimit(old)

    def to_newick_muscle(self) -> str:
        """The reference binary's exact rooted Newick layout (one token
        per line, %g edge lengths, raw labels — src/treetofile.cpp:
        ToFileNodeRooted), so -guidetreeout byte-diffs cleanly."""
        out: list[str] = []

        def rec(node: int) -> None:
            group = (not self.is_leaf(node)) or node == self.root
            if group:
                out.append("(\n")
            if self.is_leaf(node):
                out.append(self.labels[node])
            else:
                rec(self.left[node])
                out.append(",\n")
                rec(self.right[node])
            if group:
                out.append(")")
            if node != self.root:
                out.append(":%g" % self.length[node])
            out.append("\n")

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * self.node_count + 100))
        try:
            rec(self.root)
        finally:
            sys.setrecursionlimit(old)
        out.append(";\n")
        return "".join(out)

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_newick_muscle())

    @classmethod
    def from_newick(cls, text: str) -> "Tree":
        # the reference's writer is multi-line (one token per line,
        # src/treetofile.cpp); labels never contain newlines, so they
        # can be dropped wholesale (inner spaces ARE label characters)
        text = text.replace("\n", "").replace("\r", "").strip()
        if text.endswith(";"):
            text = text[:-1]
        pos = 0

        # first parse into a nested structure, then binarize + number
        def parse():
            nonlocal pos
            children = []
            if text[pos] == "(":
                pos += 1
                while True:
                    children.append(parse())
                    if text[pos] == ",":
                        pos += 1
                        continue
                    if text[pos] == ")":
                        pos += 1
                        break
            # label
            start = pos
            if pos < len(text) and text[pos] in "'\"":
                q = text[pos]
                pos += 1
                while text[pos] != q:
                    pos += 1
                pos += 1
                label = text[start + 1:pos - 1]
            else:
                while pos < len(text) and text[pos] not in ",():;":
                    pos += 1
                label = text[start:pos]
            # length
            length = 0.0
            if pos < len(text) and text[pos] == ":":
                pos += 1
                start = pos
                while pos < len(text) and text[pos] not in ",();":
                    pos += 1
                length = float(text[start:pos])
            return (label, length, children)

        rootspec = parse()

        # multifurcations are resolved left-to-right into binary joins
        leaves: list[tuple[str, float]] = []
        joins: list[tuple] = []   # (kindL, idxL, lenL, kindR, idxR, lenR)

        def build(spec):
            label, length, children = spec
            if not children:
                leaves.append((label, length))
                return ("leaf", len(leaves) - 1, length)
            sub = [build(c) for c in children]
            while len(sub) > 1:
                l = sub.pop(0)
                r = sub.pop(0)
                joins.append((l, r))
                sub.insert(0, ("join", len(joins) - 1, length if len(sub) == 0 else 0.0))
            return sub[0]

        build(rootspec)
        n = len(leaves)
        total = 2 * n - 1
        left = [-1] * total
        right = [-1] * total
        parent = [-1] * total
        length_arr = [0.0] * total
        labels: list[str | None] = [lb for lb, _ in leaves] + [None] * (n - 1)
        for i, (_, ln) in enumerate(leaves):
            length_arr[i] = ln

        def node_id(ref):
            kind, idx, _ = ref
            return idx if kind == "leaf" else n + idx

        for k, (l, r) in enumerate(joins):
            node = n + k
            li, ri = node_id(l), node_id(r)
            left[node] = li
            right[node] = ri
            parent[li] = node
            parent[ri] = node
            length_arr[li] = l[2] if l[0] == "join" else length_arr[li]
            length_arr[ri] = r[2] if r[0] == "join" else length_arr[ri]
        return cls(left, right, parent, length_arr, labels, total - 1)

    @classmethod
    def from_file(cls, path: str) -> "Tree":
        with open(path) as f:
            return cls.from_newick(f.read())


def _quote_newick(name: str) -> str:
    if any(c in name for c in " ,();:'\""):
        return "'" + name.replace("'", "''") + "'"
    return name
