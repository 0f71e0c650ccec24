"""EAGLE-style draft model (port of ``repro/core/eagle.py``; paper
Appendix C, Li et al. 2024): the concurrent sequentially-dependent
approach the paper compares against in Fig. 10.

Differences from Hydra heads (paper App. C):
  * ONE draft module (a full transformer decoder layer), not K MLPs;
  * it autoregressively predicts BOTH the next token and an estimate of the
    base model's next hidden state, feeding its own hidden estimate back —
    so later draft positions attend through the draft layer.

Chain drafting (K candidates per step).  Input at each draft position is
fc([E(token); hidden]) where ``hidden`` is the base model's hidden state
for committed positions and the EAGLE layer's own output for speculated
ones.  The draft layer keeps its own KV cache over the whole generated
stream, in ``DecodeState.prefix_k/v`` (the slot the Hydra++ prefix layer
uses; a model has one or the other).  It runs through the port's kernels:
K3 over the prompt at prefill, the dense tree-verify kernel K2 at every
draft position (T = 1) and in the rebuild (T = K + 1), and K2 in the base
model's dense verify.  As in JAX, EAGLE is served through its own step
(``eagle_spec_step``), not through the engines.

The caches update IN PLACE (JAX returns new arrays and discards the
draft-time cache).  The chain writes draft entries at ``[cache_len,
cache_len + K)``; the rebuild from the base model's true hiddens then
writes ``[cache_len, cache_len + K + 1)``, so it overwrites every draft
entry before any later step reads it (a step reads the cache only below
its ``cache_len``), and no entry below ``cache_len`` is touched.  JAX's
``commit_prefix_cache`` of a chain is the identity, so the port has none.

Training (teacher-forced, frozen base): at position t the input is
fc([E(x_{t+1}); h_t]); targets are the next-next token x_{t+2} (CE through
the base unembedding) and the next hidden state h_{t+1} (smooth-L1),
mirroring EAGLE's joint objective.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.heads import init_prefix_cache
from repro_torch.core.speculative import (PAD_TOKEN, DecodeState, StepResult,
                                          _first_token, check_criterion)
from repro_torch.core.trees import chain_tree
from repro_torch.core.verify import greedy_verify, typical_verify
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.attention import AttnInputs, gqa_fwd, init_gqa
from repro_torch.models.layers import dense_init, init_mlp, mlp_fwd, rms_norm
from repro_torch.models.model import forward, init_cache, unembed_param
from repro_torch.serving.cache import commit_cache


def init_eagle_params(cfg: ModelConfig, *, seed: int = 9, device="cuda"):
    """Random EAGLE params on ``device`` from a seeded torch.Generator,
    with the JAX init's distributions."""
    dev = resolve_device(device)
    d = cfg.d_model
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=dev)
    return {
        "fc": dense_init(gen, 2 * d, d, dtype, dev),
        "prefix": {                       # decoder layer (same as hydra++)
            "norm1": zeros(),
            "norm2": zeros(),
            "attn": init_gqa(gen, cfg, dtype, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype, dev),
        },
        "out_norm": zeros(),
    }


def _eagle_layer(dp, cfg, z, positions, cache_k, cache_v, cache_len):
    """The draft decoder layer over z (B, T, d): full-seq through K3
    (cache None), or a chain of T through K2 against the draft cache,
    whose entries ``[cache_len, cache_len + T)`` it writes in place.
    Returns (h, k, v)."""
    p = dp["prefix"]
    ai = AttnInputs(q_pos=positions, cache_k=cache_k, cache_v=cache_v,
                    cache_len=cache_len, tree_mask=None, window=0,
                    causal=True)
    a, nk, nv = gqa_fwd(p["attn"], cfg, rms_norm(z, p["norm1"], cfg.rms_eps),
                        ai)
    h = z + a
    h = h + mlp_fwd(p["mlp"], rms_norm(h, p["norm2"], cfg.rms_eps))
    return h, nk, nv


def eagle_train_loss(dp, base_params, cfg: ModelConfig, tokens, *,
                     hidden_coef: float = 0.1):
    """Joint CE + hidden-regression objective (teacher-forced), the base
    frozen (run under ``torch.no_grad()``).  Returns (loss, metrics)."""
    B, S = tokens.shape
    tokens = tokens.long()
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    with torch.no_grad():
        base = forward(base_params, cfg, tokens, pos, mode="full",
                       want_logits=False)
        h = base.hidden                                    # (B,S,d)
        E = base_params["embed"][tokens]
        unembed = unembed_param(base_params, cfg).float()

    # input at t: [E(x_{t+1}); h_t]  for t = 0..S-3
    L = S - 2
    z = torch.cat([E[:, 1:1 + L], h[:, :L]], dim=-1) @ dp["fc"]
    hhat, _, _ = _eagle_layer(dp, cfg, z, pos[:, :L], None, None, None)
    hhat = rms_norm(hhat, dp["out_norm"], cfg.rms_eps)

    logits = hhat.float() @ unembed
    tgt = tokens[:, 2:2 + L]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()
    # hidden regression vs h_{t+1} (smooth-L1)
    diff = (hhat - h[:, 1:1 + L]).float()
    hub = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                      diff.abs() - 0.5).mean()
    loss = ce + hidden_coef * hub
    acc = (torch.argmax(logits, -1) == tgt).float().mean()
    return loss, {"loss": loss, "ce": ce, "hidden_l1": hub, "acc": acc}


class EagleDraft(NamedTuple):
    tokens: torch.Tensor     # (B, K+1) chain incl. root
    logp: torch.Tensor       # (B, K+1)
    new_k: torch.Tensor      # the draft-layer cache (written in place)
    new_v: torch.Tensor


@torch.no_grad()
def eagle_draft_chain(dp, cfg: ModelConfig, base_params, K: int, h_last,
                      last_tok, cache_k, cache_v, cache_len) -> EagleDraft:
    """Draft a K-token chain.  h_last: (B, d) base hidden of the last
    committed token; the draft layer's own cache covers committed positions
    [0, cache_len) and receives the draft entries at [cache_len,
    cache_len + K), in place."""
    B = last_tok.shape[0]
    E = base_params["embed"]
    unembed = base_params["unembed_f32"]
    toks = [last_tok.long()]
    lps = [torch.zeros((B,), dtype=torch.float32, device=last_tok.device)]
    h = h_last
    tok = last_tok.long()
    for i in range(K):
        z = torch.cat([E[tok], h.to(E.dtype)], dim=-1) @ dp["fc"]
        posi = (cache_len + i)[:, None]
        hh, _, _ = _eagle_layer(dp, cfg, z[:, None, :], posi, cache_k,
                                cache_v, cache_len + i)
        hh = rms_norm(hh[:, 0], dp["out_norm"], cfg.rms_eps)
        logits = hh.float() @ unembed
        lp = torch.log_softmax(logits, dim=-1)
        tok = torch.argmax(logits, dim=-1)
        lps.append(torch.gather(lp, 1, tok[:, None])[:, 0])
        toks.append(tok)
        h = hh
    return EagleDraft(torch.stack(toks, 1), torch.stack(lps, 1), cache_k,
                      cache_v)


# ---------------------------------------------------------------------------
# full speculative step with an EAGLE draft (chain; paper Fig. 10 setup)
# ---------------------------------------------------------------------------


@torch.no_grad()
def eagle_spec_step(params, dp, cfg: ModelConfig, K: int,
                    state: DecodeState, *, criterion: str = "greedy",
                    temperature: float = 0.7, epsilon: float = 0.15,
                    generator: Optional[torch.Generator] = None,
                    gumbel: Optional[torch.Tensor] = None) -> StepResult:
    """Mirrors ``core.speculative.spec_decode_step`` with an EAGLE draft
    model.  ``state.prefix_k/v`` hold the EAGLE layer's cache (dense, (B,
    max_len, Hkv, D)).  ``criterion`` ``"typical"`` draws its bonus token
    from ``generator`` (or the given ``gumbel`` (B, V) noise)."""
    check_criterion(criterion)
    B = state.last_token.shape[0]
    dev = state.last_token.device
    tree = chain_tree(K)
    T = tree.size

    # 1. draft: the draft-time entries land at [cache_len, cache_len + K)
    #    and are all overwritten by the rebuild below
    draft = eagle_draft_chain(dp, cfg, params, K, state.last_hidden,
                              state.last_token, state.prefix_k,
                              state.prefix_v, state.cache_len)
    tokens = draft.tokens                                   # (B, K+1)

    # 2. verify
    positions = state.cache_len[:, None] + torch.arange(T, device=dev)[None]
    out = forward(params, cfg, tokens, positions, mode="verify",
                  cache=state.cache, cache_len=state.cache_len,
                  tree_mask=None)

    # 3. accept
    if criterion == "greedy":
        res = greedy_verify(tree, tokens, out.logits)
    else:
        res = typical_verify(tree, tokens, out.logits, generator,
                             temperature=temperature, epsilon=epsilon,
                             gumbel=gumbel)

    # 4. commit base cache
    new_cache = commit_cache(out.cache, state.cache_len, res.path_nodes,
                             res.n_accept, prev=state.cache)
    D1 = res.path_nodes.shape[1]
    bidx = torch.arange(B, device=dev)[:, None]
    acc_hidden = out.hidden[bidx, res.path_nodes]           # (B, D1, d)

    # 5. rebuild the eagle cache entries [cache_len, cache_len + D1) from
    #    the TRUE base hiddens: input_j = fc([E(tok_j); h_{j-1}])
    E = params["embed"]
    tok_path = tokens[bidx, res.path_nodes]                 # (B, D1)
    h_prev = torch.cat([state.last_hidden[:, None, :],
                        acc_hidden[:, :-1, :]], dim=1)
    z = torch.cat([E[tok_path], h_prev.to(E.dtype)], dim=-1) @ dp["fc"]
    ppos = state.cache_len[:, None] + torch.arange(D1, device=dev)[None, :]
    _eagle_layer(dp, cfg, z, ppos, state.prefix_k, state.prefix_v,
                 state.cache_len)

    h_next = acc_hidden[bidx[:, 0], res.n_accept]

    j = torch.arange(D1, device=dev)[None, :]
    pad = torch.full((B, 1), PAD_TOKEN, dtype=tok_path.dtype, device=dev)
    shifted = torch.cat([tok_path[:, 1:], pad], dim=1)
    emitted = torch.where(j < res.n_accept[:, None], shifted, PAD_TOKEN)
    emitted = torch.where(j == res.n_accept[:, None],
                          res.bonus_token[:, None], emitted)

    n_emitted = res.n_accept + 1
    new_state = DecodeState(
        cache=new_cache,
        cache_len=(state.cache_len + n_emitted).to(torch.int32),
        last_token=res.bonus_token, last_hidden=h_next,
        prefix_k=state.prefix_k, prefix_v=state.prefix_v)
    return StepResult(new_state, emitted, n_emitted)


@torch.no_grad()
def init_eagle_decode_state(params, dp, cfg: ModelConfig, prompt,
                            max_len: int, generator=None, *,
                            greedy: bool = True) -> DecodeState:
    """Prefill + EAGLE-cache initialization for a (B, P) prompt on its
    device.  Differs from the Hydra++ path: committed eagle-cache entries
    are keyed by fc([E(x_p); h_{p-1}]), not by raw base hiddens.  The
    first token is the argmax, or a draw from ``generator`` unless
    ``greedy``."""
    B, P = prompt.shape
    dev = prompt.device
    prompt = prompt.long()
    pos = torch.arange(P, device=dev).expand(B, P)
    cache = init_cache(cfg, B, max_len, dev)
    out = forward(params, cfg, prompt, pos, mode="full", cache=cache,
                  want_logits=False)
    tok0 = _first_token(params, out.hidden[:, -1], generator, greedy)

    E = params["embed"][prompt]                            # (B,P,d)
    h_prev = torch.cat([torch.zeros_like(out.hidden[:, :1]),
                        out.hidden[:, :-1]], dim=1)
    z = torch.cat([E, h_prev.to(E.dtype)], dim=-1) @ dp["fc"]
    _, nk, nv = _eagle_layer(dp, cfg, z, pos, None, None, None)
    pc = init_prefix_cache(cfg, B, max_len, dev)
    pk, pv = pc["k"], pc["v"]
    pk[:, :P] = nk.to(pk.dtype)
    pv[:, :P] = nv.to(pv.dtype)
    return DecodeState(cache=out.cache,
                       cache_len=torch.full((B,), P, dtype=torch.int32,
                                            device=dev),
                       last_token=tok0, last_hidden=out.hidden[:, -1],
                       prefix_k=pk, prefix_v=pv)
