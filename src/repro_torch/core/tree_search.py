"""Data-driven decoding-tree discovery (port of
``repro/core/tree_search.py``; paper §4).

Stage 1 (`measure_rank_acc`): teacher-forced evaluation of the draft heads
on a sample corpus to estimate ``acc[d, r]`` = P(the rank-r prediction of
head d is the true next-path token | the path so far was correct). Teacher
forcing the true path is exactly the "conditioned on parent accepted" event.

Stage 2 (`grow_trees`): greedy node-by-node growth — repeatedly add the
frontier candidate with maximal marginal expected-acceptance gain
P(path correct) · acc[depth, rank], yielding nested proposal trees
T_1 ⊂ T_2 ⊂ … ⊂ T_N (paper: N = 100).

Stage 3 (`select_tree`): pick the proposal maximizing measured end-to-end
throughput for the deployment batch size (benchmarks/bench_fig7_trees.py
reproduces the paper's Fig. 7–9 curves with a linear step-cost model on CPU
wall-clock measurements).
"""
from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.heads import head_logits, prefix_forward
from repro_torch.core.trees import TreeSpec, tree_from_rank_paths
from repro_torch.models.model import forward


@torch.no_grad()
def measure_rank_acc(params, draft_params, cfg: ModelConfig, tokens,
                     *, max_rank: int = 8) -> np.ndarray:
    """tokens: (B, S) eval batch (on the params' device).  Returns acc
    (K, max_rank) numpy.  ``torch.topk`` may order tied logits otherwise
    than ``jax.lax.top_k``."""
    B, S = tokens.shape
    K = cfg.draft.n_heads
    tokens = tokens.long()
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    out = forward(params, cfg, tokens, pos, mode="full", want_logits=False)
    h = out.hidden
    if "prefix" in draft_params:
        h, _, _ = prefix_forward(draft_params, cfg, h, pos)
    E = params["embed"][tokens]                           # (B, S, d)

    acc = np.zeros((K, max_rank), np.float64)
    for j in range(K):                                    # head j: +(j+2)
        Lmax = S - (j + 2)
        if Lmax <= 0:
            break
        h_in = h[:, :Lmax]
        path = torch.stack([E[:, 1 + m:1 + m + Lmax] for m in range(j + 1)],
                           dim=2)                         # (B, Lmax, j+1, d)
        lg = head_logits(draft_params, cfg, params, j, h_in, path)
        _, topk = torch.topk(lg, max_rank, dim=-1)        # (B, Lmax, R)
        tgt = tokens[:, j + 2:j + 2 + Lmax]
        hit = (topk == tgt[..., None]).cpu().numpy()      # (B, Lmax, R)
        acc[j] = hit.reshape(-1, max_rank).mean(0)
    return acc


def grow_trees(acc: np.ndarray, n_max: int = 64,
               max_children: int = 8) -> List[TreeSpec]:
    """Greedy growth; returns nested trees of sizes 2..n_max+1 (incl root).

    acc[d, r]: rank-r acceptance prob at depth d+1 (conditioned on parent).
    """
    K, R = acc.shape
    max_children = min(max_children, R)
    paths: List[Tuple[int, ...]] = []
    # frontier heap entries: (-gain, rank_path)
    heap: list = [(-float(acc[0, 0]), (0,))]
    children_count = {(): 1}
    trees: List[TreeSpec] = []
    while heap and len(paths) < n_max:
        gain, path = heapq.heappop(heap)
        paths.append(path)
        d = len(path)
        p_path = -gain
        # candidate: extend this node with its first child
        if d < K:
            heapq.heappush(heap, (-(p_path * float(acc[d, 0])), path + (0,)))
            children_count[path] = 1
        # candidate: next sibling of this node
        parent = path[:-1]
        r = children_count[parent]
        if r < max_children:
            p_parent = p_path / float(acc[d - 1, path[-1]]) \
                if acc[d - 1, path[-1]] > 0 else 0.0
            heapq.heappush(heap, (-(p_parent * float(acc[d - 1, r])),
                                  parent + (r,)))
            children_count[parent] = r + 1
        trees.append(tree_from_rank_paths(paths))
    return trees


def expected_accept_length(tree: TreeSpec, acc: np.ndarray) -> float:
    """Surrogate expected #accepted candidates (paper's greedy objective)."""
    dep, rank = tree.depth, tree.child_rank
    p = np.ones(tree.size)
    for i in range(1, tree.size):
        p[i] = p[tree.parents[i]] * acc[dep[i] - 1, rank[i]]
    return float(p[1:].sum())


def select_tree(trees: Sequence[TreeSpec], acc: np.ndarray,
                *, step_cost_base: float = 1.0,
                step_cost_per_node: float = 0.01) -> TreeSpec:
    """Throughput model: (1 + E[accept]) / (c0 + c1·T). The benchmark
    variant replaces the linear cost model with measured wall-clock."""
    best, best_tp = trees[0], -1.0
    for t in trees:
        ea = expected_accept_length(t, acc)
        tp = (1.0 + ea) / (step_cost_base + step_cost_per_node * t.size)
        if tp > best_tp:
            best, best_tp = t, tp
    return best
