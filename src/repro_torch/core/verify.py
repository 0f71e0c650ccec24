"""Verification criteria for (tree) speculative decoding (port of
``repro/core/verify.py``): greedy acceptance, typical acceptance (paper
§6.3) and rejection resampling for chains.

Returned convention: ``path_nodes`` (B, D+1) node ids of the accepted path
(root first, padded by repeating the last accepted node); ``n_accept``
(B,) number of accepted CANDIDATES (excluding the root); the model emits
one extra "bonus" token from the last accepted node's distribution.

Sampling is Gumbel-max: a categorical draw over logits ``x`` is
``argmax(x + g)`` with ``g = -log(-log(u))``, ``u`` uniform on [tiny, 1),
which is how ``jax.random.categorical`` draws.  The uniforms come from an
explicit ``torch.Generator`` on the logits' device (a CUDA generator
draws inside a captured graph, ``serving/graph.py``).  Every sampling
function also takes its noise pre-drawn (``gumbel``, ``u``), so a test
can hand in JAX's own draws and get JAX's tokens.  Greedy draws nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.trees import device_arrays


class VerifyResult(NamedTuple):
    path_nodes: torch.Tensor    # (B, D+1) int64, path_nodes[:,0] == 0
    n_accept: torch.Tensor      # (B,) int64, # accepted candidates
    bonus_token: torch.Tensor   # (B,) int64 token emitted at path end
    accept_mask: torch.Tensor   # (B, T) bool per-node acceptance


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise (fp32) drawn from ``generator``: ``-log(-log
    u)`` with ``u`` uniform on [tiny, 1), as ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_categorical(logits, generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None):
    """One draw per row from ``softmax(logits)`` over the last axis
    (Gumbel-max, fp32).  ``gumbel`` (logits' shape) replaces the draw from
    ``generator``."""
    if gumbel is None:
        if generator is None:
            raise ValueError("sampling needs a generator (or gumbel noise)")
        gumbel = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(gumbel + logits.float(), dim=-1)


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


def typical_thresholds(base_logits, *, temperature: float, epsilon: float,
                       alpha: Optional[float] = None):
    """(probabilities (B, T, V) at ``temperature``, thresholds (B, T)):
    ``min(epsilon, alpha * exp(-H))`` with H the entropy of each node's
    tempered distribution, alpha = sqrt(epsilon) by default; fp32."""
    if alpha is None:
        alpha = math.sqrt(epsilon)
    logp = torch.log_softmax(base_logits.float() / temperature, dim=-1)
    probs = torch.exp(logp)
    H = -torch.sum(probs * logp, dim=-1)                   # (B, T) entropy
    return probs, torch.clamp(alpha * torch.exp(-H), max=epsilon)


def typical_verify(tree, tree_tokens, base_logits,
                   generator: Optional[torch.Generator] = None, *,
                   temperature: float = 0.7, epsilon: float = 0.15,
                   alpha: Optional[float] = None,
                   gumbel: Optional[torch.Tensor] = None) -> VerifyResult:
    """Typical acceptance (paper §6.3, Cai et al. 2024): accept x̂ iff

        p_base(x̂ | parent path; τ) > min(ε, α · exp(-H(p_base(·|...; τ))))

    and its parent is accepted, walked in topological order.  The bonus
    token is drawn from the last accepted node's tempered distribution:
    ``gumbel`` (B, V) noise, or a draw of it from ``generator``."""
    B, T, _ = base_logits.shape
    probs, thresh = typical_thresholds(base_logits, temperature=temperature,
                                       epsilon=epsilon, alpha=alpha)
    ok = torch.ones((B, T), dtype=torch.bool, device=base_logits.device)
    for i in range(1, T):  # topological order
        p = tree.parents[i]
        p_tok = torch.gather(probs[:, p], 1, tree_tokens[:, i:i + 1].long())
        ok[:, i] = ok[:, p] & (p_tok[:, 0] > thresh[:, p])
    path, n_accept, best = _accept_to_path(tree, ok)
    bidx = torch.arange(B, device=base_logits.device)
    best_logits = base_logits[bidx, best].float() / temperature   # (B, V)
    bonus = sample_categorical(best_logits, generator, gumbel)
    return VerifyResult(path, n_accept, bonus, ok)


def chain_rejection_verify(tree_tokens, draft_logp, base_logits,
                           generator: Optional[torch.Generator] = None, *,
                           temperature: float = 1.0,
                           u: Optional[torch.Tensor] = None,
                           gumbel: Optional[torch.Tensor] = None
                           ) -> VerifyResult:
    """Rejection resampling (Leviathan et al.) for CHAIN speculation:
    ``tree_tokens`` (B, K+1) with [:, 0] the root, ``draft_logp`` (B, K+1)
    the draft log-prob of each candidate.  Candidate i is accepted while
    ``u[:, i-1] < min(1, p_base / max(p_draft, 1e-20))``.  As in the
    reference, the bonus comes from the BASE distribution at ``n_accept``
    (not the residual ``max(0, p - q)``), so a rejected position is not
    distribution-preserving.  ``u`` (B, K) and ``gumbel`` (B, V) replace
    the draws from ``generator`` (``u`` first, then the bonus noise; JAX
    draws the bonus from ``fold_in(rng, 1)``)."""
    B, T = tree_tokens.shape
    dev = base_logits.device
    logp = torch.log_softmax(base_logits.float() / temperature, dim=-1)
    if u is None:
        if generator is None:
            raise ValueError("rejection sampling needs a generator (or u)")
        u = torch.rand((B, T - 1), generator=generator, device=dev,
                       dtype=torch.float32)
    ok = torch.ones((B,), dtype=torch.bool, device=dev)
    n_accept = torch.zeros((B,), dtype=torch.long, device=dev)
    for i in range(1, T):
        p_base = torch.exp(torch.gather(
            logp[:, i - 1], 1, tree_tokens[:, i:i + 1].long()))[:, 0]
        p_draft = torch.exp(draft_logp[:, i].float())
        ratio = torch.clamp(p_base / torch.clamp(p_draft, min=1e-20), max=1.0)
        ok = ok & (u[:, i - 1] < ratio)
        n_accept = n_accept + ok.long()
    ar = torch.arange(T, device=dev)[None, :]
    path = torch.minimum(ar, n_accept[:, None])
    bonus_logits = logp[torch.arange(B, device=dev), n_accept]
    bonus = sample_categorical(bonus_logits, generator, gumbel)
    return VerifyResult(path, n_accept, bonus, ar <= n_accept[:, None])
