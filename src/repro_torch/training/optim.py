"""AdamW + cosine LR schedule + global-norm clipping (port of
``repro/training/optim.py``; paper §5 training recipe: AdamW β1=0.9
β2=0.999, cosine with warmup, peak 1e-3).

The moments are fp32 whatever the param dtype, and the update is computed
in fp32 and cast back to the param's dtype, as JAX computes it
(``torch.optim.AdamW`` keeps its moments in the param dtype, so it is not
this function).  The port updates params and moments IN PLACE, under
``torch.no_grad()``, and returns the same trees; the trees are walked in
JAX's flatten order (``training/pytree.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.training.pytree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: object                  # fp32 first moments, the params' layout
    nu: object                  # fp32 second moments


def init_adamw(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_schedule(step, *, peak_lr: float = 1e-3, warmup: int = 100,
                    total: int = 10000, floor: float = 0.0):
    """The learning rate at ``step`` (an int or a 0-d tensor), fp32."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float = 1.0):
    """Scales ``grads`` IN PLACE to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.minimum(torch.ones_like(gn),
                          max_norm / torch.clamp_min(gn, 1e-9))
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gn


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One AdamW step: updates ``params`` and the moments of ``state`` in
    place; returns (params, the state with its step advanced)."""
    step = state.step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_(p32 - lr.to(p.device) * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
