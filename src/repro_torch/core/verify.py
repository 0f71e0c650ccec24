"""Greedy verification for (tree) speculative decoding (port of
``repro/core/verify.py::greedy_verify``).

Returned convention: ``path_nodes`` (B, D+1) node ids of the accepted path
(root first, padded by repeating the last accepted node); ``n_accept``
(B,) number of accepted CANDIDATES (excluding the root); the model emits
one extra "bonus" token from the last accepted node's distribution.
Typical acceptance and rejection resampling draw from ``jax.random`` on
the JAX side and are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.trees import device_arrays


class VerifyResult(NamedTuple):
    path_nodes: torch.Tensor    # (B, D+1) int64, path_nodes[:,0] == 0
    n_accept: torch.Tensor      # (B,) int64, # accepted candidates
    bonus_token: torch.Tensor   # (B,) int64 token emitted at path end
    accept_mask: torch.Tensor   # (B, T) bool per-node acceptance


def _accept_to_path(tree, accepted):
    """accepted: (B, T) bool (root always True).  Deepest accepted node
    wins, leftmost (lowest node id) tie-break."""
    T = accepted.shape[1]
    ta = device_arrays(tree, accepted.device)
    dep = ta["depth"]
    ar = torch.arange(T, device=accepted.device)
    score = torch.where(accepted, dep[None, :] * T - ar[None, :], -1)
    best = torch.argmax(score, dim=1)                      # (B,)
    n_accept = dep[best]
    path = ta["ancestors"][best]                           # (B, D+1)
    # pad entries beyond depth with the best (deepest) node itself
    D1 = path.shape[1]
    pad = torch.arange(D1, device=accepted.device)[None, :] > n_accept[:, None]
    path = torch.where(pad, best[:, None], path)
    return path, n_accept, best


def greedy_verify(tree, tree_tokens, base_logits) -> VerifyResult:
    """Accept a candidate iff it equals the base model's argmax at its
    parent (and its parent is accepted)."""
    B, T, _ = base_logits.shape
    argmax = torch.argmax(base_logits, dim=-1)             # (B, T)
    ok = torch.ones((B, T), dtype=torch.bool, device=base_logits.device)
    for i in range(1, T):  # topological order
        p = tree.parents[i]
        ok[:, i] = ok[:, p] & (tree_tokens[:, i] == argmax[:, p])
    path, n_accept, best = _accept_to_path(tree, ok)
    bonus = torch.gather(argmax, 1, best[:, None])[:, 0]
    return VerifyResult(path, n_accept, bonus, ok)
