"""Static candidate trees for tree-based speculative decoding (paper §2, §4).

A tree is a compile-time-static topology. Node 0 is the ROOT and holds the
most recently generated (not yet forwarded) token x_t; nodes 1..T-1 hold
speculated candidates. ``parents[i] < i`` (topological order), node i at
depth d means it speculates the d-th future token. ``child_rank[i]`` = rank
of node i among its siblings (rank r => the r-th most likely continuation of
its parent under the draft model).

A numpy copy of ``repro/core/trees.py``: the port keeps its own so it
imports nothing of the JAX package.  All derived arrays are numpy;
``device_arrays`` moves what the decode step indexes with to a device,
once per (tree, device).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TreeSpec:
    parents: Tuple[int, ...]            # parents[0] == -1

    def __post_init__(self):
        p = self.parents
        assert p[0] == -1 and all(0 <= p[i] < i for i in range(1, len(p)))

    @property
    def size(self) -> int:
        return len(self.parents)

    @property
    def depth(self) -> np.ndarray:
        d = np.zeros(self.size, np.int32)
        for i in range(1, self.size):
            d[i] = d[self.parents[i]] + 1
        return d

    @property
    def max_depth(self) -> int:
        return int(self.depth.max())

    @property
    def child_rank(self) -> np.ndarray:
        r = np.zeros(self.size, np.int32)
        seen: dict = {}
        for i in range(1, self.size):
            p = self.parents[i]
            r[i] = seen.get(p, 0)
            seen[p] = r[i] + 1
        return r

    @property
    def n_children(self) -> np.ndarray:
        c = np.zeros(self.size, np.int32)
        for i in range(1, self.size):
            c[self.parents[i]] += 1
        return c

    @property
    def ancestor_mask(self) -> np.ndarray:
        """(T, T) bool: mask[i, j] = j is an ancestor of i, or j == i."""
        T = self.size
        m = np.eye(T, dtype=bool)
        for i in range(1, T):
            m[i] |= m[self.parents[i]]
        return m

    @property
    def ancestors(self) -> np.ndarray:
        """(T, max_depth+1): ancestors[i, d] = ancestor of node i at depth d
        (= i itself at its own depth; 0-padded above)."""
        T, D = self.size, self.max_depth
        a = np.zeros((T, D + 1), np.int32)
        dep = self.depth
        for i in range(T):
            j = i
            while j >= 0:
                a[i, dep[j]] = j
                j = self.parents[j]
        return a

    @property
    def nodes_at_depth(self) -> List[np.ndarray]:
        dep = self.depth
        return [np.where(dep == d)[0] for d in range(self.max_depth + 1)]

    def path_to(self, node: int) -> List[int]:
        out = []
        j = node
        while j >= 0:
            out.append(j)
            j = self.parents[j]
        return out[::-1]


@functools.lru_cache(maxsize=None)
def device_arrays(tree: TreeSpec, device) -> dict:
    """The tree's index arrays as torch tensors on ``device`` (cached, so
    a decode step makes no host-to-device copies for them):

    ``depth`` (T,), ``ancestors`` (T, D+1), ``mask`` (T, T) bool, and
    ``levels``: per depth d >= 1, the node ids at that depth, their
    root-to-parent paths (n, d), child ranks and the top-k width."""
    import torch

    as_long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                        device=device)
    depth, anc, rank = tree.depth, tree.ancestors, tree.child_rank
    levels = []
    for d in range(1, tree.max_depth + 1):
        nodes = np.where(depth == d)[0]
        levels.append({"nodes": as_long(nodes),
                       "path_ids": as_long(anc[nodes][:, :d]),
                       "rank": as_long(rank[nodes]),
                       "kmax": int(rank[nodes].max()) + 1})
    return {"depth": as_long(depth), "ancestors": as_long(anc),
            "mask": torch.as_tensor(tree.ancestor_mask, device=device),
            "levels": levels}


def chain_tree(k: int) -> TreeSpec:
    """Root + a single path of k candidates (chain speculation for SSMs /
    plain speculative decoding)."""
    return TreeSpec(tuple([-1] + list(range(k))))


def tree_from_rank_paths(paths: Sequence[Sequence[int]]) -> TreeSpec:
    """Medusa-style tree spec: each path is a tuple of child ranks, e.g.
    (0,), (1,), (0, 0), (0, 1) ... Node ids assigned in BFS-ish insertion
    order; duplicate prefixes are shared."""
    parents = [-1]
    index: dict = {(): 0}
    for path in sorted(paths, key=lambda q: (len(q), q)):
        for d in range(1, len(path) + 1):
            pre = tuple(path[:d])
            if pre not in index:
                index[pre] = len(parents)
                parents.append(index[tuple(path[:d - 1])])
    return TreeSpec(tuple(parents))


def default_tree(size: int = 16, max_children: int = 4,
                 max_depth: int = 4) -> TreeSpec:
    """A reasonable static default (greedy-ish wide-then-deep): used before
    a data-driven tree (core/tree_search.py) is available."""
    paths = []
    # depth-1 fanout first, then extend rank-0 spine, then fill
    for r in range(max_children):
        paths.append((r,))
    spine: Tuple[int, ...] = (0,)
    for d in range(2, max_depth + 1):
        spine = spine + (0,)
        paths.append(spine)
    # fill remaining with second-rank children along shallow nodes
    extra = [(0, 1), (1, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0), (2, 0),
             (0, 2), (1, 1), (3, 0), (0, 0, 0, 1), (2, 0, 0), (0, 1, 1)]
    for e in extra:
        if 1 + len(paths) + 1 > size:
            break
        if len(e) <= max_depth:
            paths.append(e)
    t = tree_from_rank_paths(paths)
    # trim/accept: rebuild until size fits
    while t.size > size:
        paths.pop()
        t = tree_from_rank_paths(paths)
    return t


def mc_sim_expected_accept(tree: TreeSpec, rank_acc: np.ndarray) -> float:
    """Expected acceptance length of a tree under an independence model:
    rank_acc[d, r] = P(candidate at depth d+1 with child rank r is correct
    | parent correct). Used by tree search and tests."""
    T = tree.size
    dep, rank = tree.depth, tree.child_rank
    p_node = np.ones(T)
    for i in range(1, T):
        p_node[i] = p_node[tree.parents[i]] * rank_acc[dep[i] - 1, rank[i]]
    # expected depth of deepest accepted path: E[max over leaves] is
    # intractable in closed form under correlations; standard practice
    # (Medusa) uses sum of node acceptance probs as the surrogate:
    # E[#accepted nodes on best path] <= sum_i p_node[i] and equals it when
    # siblings are disjoint events. We report the surrogate.
    return float(p_node[1:].sum())
