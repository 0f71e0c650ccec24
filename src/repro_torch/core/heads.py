"""Draft heads (port of ``repro/core/heads.py``): Medusa (sequentially
independent), Hydra (sequentially dependent, paper §3) and Hydra++
(§3.1: deeper MLPs and PrefixAttention) all come through the same code.

Head i (0-based) predicts the token (i+1) steps ahead of the last verified
token x_t:

  Medusa:  p(x_{t+1+i}) = f_i(h)
  Hydra:   p(x_{t+1+i}) = f_i(h, E[x_t], E[x̂_{t+1}], ..., E[x̂_{t+i}])

Hydra head MLP: Linear((i+2)·d -> d) + SiLU, then (n_mlp_layers-1) residual
SiLU blocks, a norm, then the unembedding (the base model's fp32 copy when
tied, as by default).

PrefixAttention (Hydra++): one extra decoder layer on top of the base
model's hidden-state stream, queried once per decoding step; all heads
read its output instead of the raw base hidden state.  Its decode path
goes through the same paged kernel as the base stack when the engine is
paged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trees import device_arrays
from repro_torch.device import resolve_device, seeded_generator, torch_dtype
from repro_torch.models.attention import AttnInputs, gqa_fwd, init_gqa
from repro_torch.models.layers import dense_init, init_mlp, mlp_fwd, rms_norm
from repro_torch.models.model import unembedding

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_draft_params(cfg: ModelConfig, *, seed: int = 1, device="cuda"):
    """Random draft params on ``device`` from a seeded torch.Generator,
    with the JAX init's distributions."""
    dev = resolve_device(device)
    dc = cfg.draft
    d, V = cfg.d_model, cfg.vocab_size
    dtype = torch_dtype(cfg.dtype)
    gen = seeded_generator(dev, seed)
    heads = []
    for i in range(dc.n_heads):
        in_dim = d if dc.kind == "medusa" else (i + 2) * d
        hp = {"w_in": dense_init(gen, in_dim, d, dtype, dev),
              "out_norm": torch.zeros((d,), dtype=dtype, device=dev)}
        for m in range(dc.n_mlp_layers - 1):
            hp[f"w_res{m}"] = dense_init(gen, d, d, dtype, dev, scale=0.02)
        if not dc.tie_unembed:
            hp["unembed"] = dense_init(gen, d, V, dtype, dev)
        heads.append(hp)
    params = {"heads": heads}
    if dc.prefix_attention:
        params["prefix"] = {
            "norm1": torch.zeros((d,), dtype=dtype, device=dev),
            "norm2": torch.zeros((d,), dtype=dtype, device=dev),
            "attn": init_gqa(gen, cfg, dtype, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype, dev),
        }
    return params


# ---------------------------------------------------------------------------
# prefix attention
# ---------------------------------------------------------------------------


def prefix_forward(dp, cfg: ModelConfig, hidden, positions, *,
                   cache_k=None, cache_v=None, cache_len=None,
                   tree_mask=None, block_table=None, prefill: bool = False):
    """Extra decoder layer over the base model's hidden-state stream.

    hidden: (B, T, d).  Full-seq (cache_* None) at prefill; the cache path
    when decoding (chain mask by default), updating the cache in place.
    ``block_table`` switches cache_k/v to the paged pool layout (same
    per-slot tables as the KV pools).  ``prefill=True`` (with a cache)
    runs the chunked-prefill continuation instead of the decode path: the
    T hiddens are one prompt chunk at ``cache_len + arange(T)``, attended
    through K3's chunk form (DESIGN.md §8).  Returns (out, new_k, new_v).
    Grad mode is the caller's: Hydra++ training differentiates the
    full-seq path (K3 through its autograd wrapper); serving calls it
    under ``torch.no_grad()``."""
    p = dp["prefix"]
    ai = AttnInputs(q_pos=positions, cache_k=cache_k, cache_v=cache_v,
                    cache_len=cache_len, tree_mask=tree_mask, window=0,
                    causal=True, block_table=block_table, prefill=prefill)
    a, nk, nv = gqa_fwd(p["attn"], cfg, rms_norm(hidden, p["norm1"],
                                                 cfg.rms_eps), ai)
    h = hidden + a
    h = h + mlp_fwd(p["mlp"], rms_norm(h, p["norm2"], cfg.rms_eps))
    return h, nk, nv


def init_prefix_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtype = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# head application
# ---------------------------------------------------------------------------


def head_logits(dp, cfg: ModelConfig, base_params, i: int, h, path_embs):
    """Head i logits.

    h: (..., d) draft-model hidden state (base hidden or prefix output).
    path_embs: (..., i+1, d) embeddings [E(x_t), E(x̂_{t+1}),...,E(x̂_{t+i})]
    (ignored for Medusa heads).  Returns fp32 logits (..., V)."""
    hp = dp["heads"][i]
    if cfg.draft.kind == "medusa":
        x = h
    else:
        flat = path_embs.reshape(*path_embs.shape[:-2], -1)
        x = torch.cat([h, flat.to(h.dtype)], dim=-1)
    z = F.silu(x @ hp["w_in"])
    for m in range(cfg.draft.n_mlp_layers - 1):
        z = z + F.silu(z @ hp[f"w_res{m}"])
    z = rms_norm(z, hp["out_norm"])
    unembed = (unembedding(base_params, cfg) if cfg.draft.tie_unembed
               else hp["unembed"].float())
    return z.float() @ unembed


# ---------------------------------------------------------------------------
# tree drafting
# ---------------------------------------------------------------------------


@torch.no_grad()
def draft_tree_tokens(dp, cfg: ModelConfig, base_params, tree, h, last_tok):
    """Populate the candidate tree (paper §2 'tree decoding' + §3).

    h: (B, d); last_tok: (B,).  Returns (tokens (B,T) int64, logp (B,T)
    fp32 draft log-prob of each node's token given its path).  Level by
    level: depth-d nodes are filled from head d-1 queried with the
    (sequentially dependent, for Hydra) path embeddings.  Ties in the
    top-k may break differently from ``jax.lax.top_k``."""
    B = h.shape[0]
    ta = device_arrays(tree, h.device)
    embed = base_params["embed"]
    tokens = torch.zeros((B, tree.size), dtype=torch.long, device=h.device)
    tokens[:, 0] = last_tok
    logp = torch.zeros((B, tree.size), dtype=torch.float32, device=h.device)
    bidx = torch.arange(B, device=h.device)[:, None]
    for d, lv in enumerate(ta["levels"], start=1):
        n = lv["nodes"].shape[0]
        hh = h[:, None, :].expand(B, n, h.shape[-1])
        path_embs = (None if cfg.draft.kind == "medusa"
                     else embed[tokens[:, lv["path_ids"]]])   # (B, n, d, dm)
        lg = head_logits(dp, cfg, base_params, d - 1, hh, path_embs)
        lp = torch.log_softmax(lg, dim=-1)                    # (B, n, V)
        top_lp, top_tok = torch.topk(lp, lv["kmax"], dim=-1)  # (B, n, kmax)
        node_idx = torch.arange(n, device=h.device)[None, :]
        tokens[:, lv["nodes"]] = top_tok[bidx, node_idx, lv["rank"][None, :]]
        logp[:, lv["nodes"]] = top_lp[bidx, node_idx, lv["rank"][None, :]]
    return tokens, logp
