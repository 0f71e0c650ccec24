"""DeepSeek-style fine-grained MoE: shared experts + routed top-k experts
(port of ``repro/models/moe.py``), with the router's Switch-style
load-balance loss.

Dispatch is sort/scatter-based, not one-hot-einsum, so routed FLOPs scale
with E * C * d * d_e rather than N * E * C * d:

  1. fp32 router softmax -> top_k (expert id, weight) per token, weights
     renormalised over the k;
  2. tokens are placed into a per-expert capacity buffer (capacity C, a
     rank from one cumsum over the one-hot choices); overflow tokens are
     dropped (their routed contribution is zero; the shared experts and
     the residual still apply);
  3. batched expert GEMMs over (E, C, d);
  4. results gathered back with the combine weights, summed in fp32.

The expert GEMMs are plain ``torch.einsum`` (batched matmuls), as the
JAX package leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, init_mlp, mlp_fwd

# Expert capacity is computed from the token count rounded UP to this
# multiple (copied from the JAX package, which explains it): with the raw
# count N = B*T, an exact-length prefill (N = P) and a bucket-padded one
# (N = pad(P)) got different capacities, so different tokens overflowed
# and a real token's routed output changed by a whole expert's.  Rounding
# the basis makes C invariant to right-padding for every bucket that
# divides 64; right-pad tokens rank after every real token in the cumsum,
# so with equal C they never displace one.
CAPACITY_ROUND = 64


def capacity(n_tokens: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens."""
    mo = cfg.moe
    n_cap = -(-n_tokens // CAPACITY_ROUND) * CAPACITY_ROUND
    return int(max(8, (n_cap * mo.top_k * capacity_factor) // mo.n_routed))


def init_moe(gen, cfg, dtype, device):
    """Random MoE params: the router in fp32 (as in JAX), the routed
    experts stacked on a leading (E, ...) axis, the shared experts as one
    MLP ``n_shared`` experts wide."""
    mo = cfg.moe
    d, E, de = cfg.d_model, mo.n_routed, mo.d_expert
    p = {"router": dense_init(gen, d, E, torch.float32, device)}
    for name, (d_in, d_out) in (("w_gate", (d, de)), ("w_up", (d, de)),
                                ("w_down", (de, d))):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
        for e in range(E):
            w[e] = dense_init(gen, d_in, d_out, dtype, device)
        p[name] = w
    if mo.n_shared:
        p["shared"] = init_mlp(gen, d, de * mo.n_shared, dtype, device)
    return p


def moe_fwd(p, cfg, x, *, capacity_factor: float = 1.25,
            want_aux: bool = True):
    """x: (B, T, d) -> (out (B, T, d) in x's dtype, aux).  Routed top-k +
    shared experts.  ``aux`` is the router's load-balance loss, 0-d fp32,
    E * sum_e(mean router prob of e * share of the top-k choices that
    picked e) * ``router_aux_coef``, or None without ``want_aux`` (only
    ``lm_loss`` reads it; serving computes none).  The dispatch stays on
    the autograd graph: the token rows reach the experts through
    ``index_add_`` and the combine weights ``top_w`` carry the router's
    gradient."""
    mo = cfg.moe
    B, T, d = x.shape
    N = B * T
    E, K = mo.n_routed, mo.top_k
    xf = x.reshape(N, d)

    logits = xf.float() @ p["router"].float()               # (N, E) fp32
    probs = torch.softmax(logits, dim=-1)
    # ties may break differently from jax.lax.top_k (ROADMAP §3)
    top_w, top_e = torch.topk(probs, K, dim=-1)              # (N, K)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(N * K)
    onehot = F.one_hot(flat_e, E)                            # (NK, E)
    aux = None
    if want_aux:                              # Switch-style load balance
        me = probs.mean(0)                                   # (E,)
        ce = onehot.sum(0).float() / (N * K)  # JAX's scatter-add, no sync
        aux = E * torch.sum(me * ce) * mo.router_aux_coef

    # capacity assignment: the rank of each (token, choice) within its
    # expert is the count of earlier choices of that expert
    C = capacity(N, cfg, capacity_factor)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    pos = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = flat_e * C + torch.where(keep, pos, 0)            # (NK,)

    # dropped choices add zero rows to their expert's slot 0: the only
    # repeated targets add exact zeros, so the order of the adds does not
    # matter
    tok = xf.repeat_interleave(K, dim=0)                     # (NK, d)
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, torch.where(keep[:, None], tok, 0))
    buf = buf.reshape(E, C, d)

    g = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    u = torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    eo = torch.einsum("ecf,efd->ecd", g * u, p["w_down"]).reshape(E * C, d)

    w = (top_w.reshape(N * K) * keep).float()
    out = (eo[slot].float() * w[:, None]).reshape(N, K, d).sum(1)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xf).float()
    return out.reshape(B, T, d).to(x.dtype), aux
