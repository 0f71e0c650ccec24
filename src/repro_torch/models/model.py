"""Model assembly (port of ``repro/models/model.py``): attention stacks
(the ``attn_stack_dense`` and ``attn_stack_moe`` groups: GQA,
full-attention or sliding-window, or DeepSeek-V2's MLA; dense or MoE FFN)
and the RWKV6 recurrent stack (``rwkv_stack``).

The params keep the JAX pytree's layout so the bridge converts one-to-one:
``embed (V, d)``, ``final_norm``, ``lm_head (d, V)`` unless embeddings are
tied, and one entry of ``groups`` per group of ``group_program`` (an MoE
config has a dense group of ``n_dense_layers`` and then an MoE group),
with every leaf stacked on a leading layer axis.  One more entry,
``unembed_f32``, holds the fp32 unembedding the logits multiply with.
JAX upcasts the ``(d, V)`` unembedding on every call; the port makes that
copy once, at load (3.1 GB at minitron-4b, see PERF.md).

Caches are a list with one dict per group.  An attention group holds
``{"k", "v"}``: dense ``(L, B, S, Hkv, D)`` per-slot arrays, or — with a
block table — global pools ``(L, N, bs, Hkv, D)``.  An MLA group caches
the latent and the rope key instead: ``k`` is ``(L, B|N, S|bs, r)``, ``v``
``(L, ..., rd)``.  An RWKV6 group holds recurrent state with no sequence
axis, per slot under any layout: ``wkv_state (L, B, H, 64, 64)`` fp32 and
the token-shift states ``shift_tm``/``shift_cm (L, B, 1, d)``.  ``forward``
updates the attention caches IN PLACE (JAX returns new arrays) and
returns the same tensors; in full mode it writes an RWKV6 group's final
states in place too, while in verify mode it leaves the committed state
alone and returns, for that group, new per-token CANDIDATE states
(``(L, B, T, ...)``) that ``serving/cache.py::commit_cache`` selects from.

A group with sliding-window layers (gemma3's 5 local : 1 global pattern)
runs its paged verify through the windowed kernel K4, each layer with its
own window (0 for the global layers), as JAX picks the windowed template
variant per group.  An MLA stack runs its paged verify through K5.  An
RWKV6 stack runs its prefill scan through K6 and its verify scan (per
token, every state kept) in plain PyTorch, ignoring the tree mask (its
trees are chains) and any block table (it has nothing to page).

Execution modes:
  'full'   — prefill over the whole sequence; fills ``cache`` at [0, T).
             With ``cache`` AND ``cache_len`` it is a chunked-prefill
             continuation (DESIGN.md §8): the T tokens sit at
             ``cache_len + arange(T)``, attention groups write them
             there (dense, or paged through ``block_table``) and attend
             through K3's chunk form, and an RWKV6 group scans on from
             its carried state (the caller zeroes it for a first chunk)
  'verify' — T speculative tokens (tree or chain) against a populated
             cache; dense, or paged through ``block_table``
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.attention import (AttnInputs, gqa_fwd, init_gqa,
                                          init_mla, mla_fwd)
from repro_torch.models.layers import embed_init, init_mlp, mlp_fwd, rms_norm
from repro_torch.models.moe import init_moe, moe_fwd
from repro_torch.models.ssm import (_gather_last_valid, init_rwkv6,
                                    rwkv6_chanmix, rwkv6_timemix)


class ModelOutputs(NamedTuple):
    hidden: torch.Tensor                 # (B, T, d) final-norm hidden states
    logits: Optional[torch.Tensor]       # (B, T, V) fp32
    cache: Any                           # the (updated in place) cache


def group_program(cfg: ModelConfig):
    """Returns a list of (kind, n_layers) describing the stack."""
    if cfg.block_kind == "rwkv6":
        return [("rwkv_stack", cfg.n_layers)]
    if cfg.block_kind != "attn" or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention stacks and RWKV6 only "
            "so far")
    if cfg.moe:
        nd = cfg.moe.n_dense_layers
        out = [("attn_stack_dense", nd)] if nd else []
        out.append(("attn_stack_moe", cfg.n_layers - nd))
        return out
    return [("attn_stack_dense", cfg.n_layers)]


def _window_array(cfg: ModelConfig, n_layers: int, offset: int = 0):
    """Per-layer windows of layers ``[offset, offset + n_layers)`` (0 =>
    full attention).  JAX makes them a traced int32 scan operand; the
    port runs eagerly, so they are plain ints."""
    return [cfg.window_for_layer(i + offset) for i in range(n_layers)]


def group_has_window(cfg: ModelConfig, offset: int, n: int) -> bool:
    """True when any layer in ``[offset, offset + n)`` is sliding-window:
    the group's paged verify then takes the windowed kernel K4 (0 is an
    exact mask no-op for the group's global layers)."""
    return any(cfg.window_for_layer(offset + i) > 0 for i in range(n))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn_layer(gen, cfg, dtype, device, moe_ffn: bool):
    d = cfg.d_model
    p = {
        "norm1": torch.zeros((d,), dtype=dtype, device=device),
        "norm2": torch.zeros((d,), dtype=dtype, device=device),
        "attn": (init_mla(gen, cfg, dtype, device) if cfg.mla
                 else init_gqa(gen, cfg, dtype, device)),
    }
    if moe_ffn:
        p["moe"] = init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def _init_rwkv_layer(gen, cfg, dtype, device):
    d = cfg.d_model
    return {"norm1": torch.zeros((d,), dtype=dtype, device=device),
            "norm2": torch.zeros((d,), dtype=dtype, device=device),
            "rwkv": init_rwkv6(gen, cfg, dtype, device)}


def _init_stacked(n: int, init_layer):
    """A group of ``n`` layers with (n, ...) leaves, each leaf allocated
    once and filled layer by layer, so at most one layer's params exist
    beside the stack (stacking a list of layers would hold the group
    twice: ~58 GB for deepseek-v2-lite's MoE group)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i] = src

    first = init_layer()
    stacked = alloc(first)
    fill(stacked, first, 0)
    del first
    for i in range(1, n):
        fill(stacked, init_layer(), i)
    return stacked


def layer(tree, i: int):
    """Layer ``i``'s params (views) from a stacked group."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def add_unembed_f32(params, cfg: ModelConfig):
    """Attach the fp32 unembedding ``(d, V)`` the logits use (one copy,
    made at load; a no-op view when params are already fp32)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    params["unembed_f32"] = w.float().contiguous()
    return params


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random params drawn on ``device`` from a seeded torch.Generator,
    with the JAX init's distributions (not its numbers)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev).T.contiguous()
    params["groups"] = [
        _init_stacked(n, lambda kind=kind: (
            _init_rwkv_layer(gen, cfg, dtype, dev) if kind == "rwkv_stack"
            else _init_attn_layer(gen, cfg, dtype, dev,
                                  moe_ffn=kind == "attn_stack_moe")))
        for kind, n in group_program(cfg)]
    return add_unembed_f32(params, cfg)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None):
    """Committed cache: one entry per group, zeros.  With
    (batch=num_blocks, max_len=block_size) the attention entries are
    exactly the pool; recurrent-state entries have no sequence axis and
    are per slot (``batch`` rows), so ``max_len`` does not shape them."""
    dtype = dtype or torch_dtype(cfg.dtype)
    caches = []
    for kind, n in group_program(cfg):
        if kind == "rwkv_stack":
            H, d = cfg.n_heads, cfg.d_model
            hd = d // H
            caches.append({
                "wkv_state": torch.zeros((n, batch, H, hd, hd),
                                         dtype=torch.float32, device=device),
                "shift_tm": torch.zeros((n, batch, 1, d), dtype=dtype,
                                        device=device),
                "shift_cm": torch.zeros((n, batch, 1, d), dtype=dtype,
                                        device=device)})
            continue
        if cfg.mla:
            m = cfg.mla
            shapes = ((n, batch, max_len, m.kv_lora_rank),
                      (n, batch, max_len, m.qk_rope_dim))
        else:
            kv = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            shapes = (kv, kv)
        caches.append({key: torch.zeros(shape, dtype=dtype, device=device)
                       for key, shape in zip(("k", "v"), shapes)})
    return caches


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rwkv_group_fwd(gp, cfg, h, n: int, gc, *, is_verify: bool, valid_len):
    """An RWKV6 group: time-mix then channel-mix per layer, from the
    committed states in ``gc`` (zeros when None).  Full mode writes the
    final states into ``gc`` in place (the shift states taken at
    ``valid_len - 1``) and returns it; verify mode returns per-token
    candidates ``{"wkv_state": (L,B,T,H,hd,hd), "shift_tm"/"shift_cm":
    (L,B,T,1,d)}`` and leaves ``gc`` alone."""
    B, T, d = h.shape
    mode = "verify" if is_verify else "full"
    chunk = cfg.ssm.chunk_size            # the prefill's chunk, as in JAX
    cand = None
    if is_verify:
        H = cfg.n_heads
        hd = d // H
        cand = {"wkv_state": torch.empty((n, B, T, H, hd, hd),
                                         dtype=torch.float32,
                                         device=h.device),
                "shift_tm": torch.empty((n, B, T, 1, d), dtype=h.dtype,
                                        device=h.device),
                "shift_cm": torch.empty((n, B, T, 1, d), dtype=h.dtype,
                                        device=h.device)}
    for i in range(n):
        lp = layer(gp, i)
        st = layer(gc, i) if gc is not None else {}
        x1 = rms_norm(h, lp["norm1"], cfg.rms_eps)
        o, ns = rwkv6_timemix(lp["rwkv"], cfg, x1, mode=mode,
                              wkv_state=st.get("wkv_state"),
                              shift_last=st.get("shift_tm"), chunk=chunk,
                              valid_len=None if is_verify else valid_len)
        h = h + o
        x2 = rms_norm(h, lp["norm2"], cfg.rms_eps)
        h = h + rwkv6_chanmix(lp["rwkv"], x2, shift_last=st.get("shift_cm"))
        if is_verify:
            cand["wkv_state"][i] = ns["wkv_state"]
            cand["shift_tm"][i] = ns["shift_tm"]
            cand["shift_cm"][i] = x2[:, :, None, :]
        elif gc is not None:
            gc["wkv_state"][i] = ns["wkv_state"]
            gc["shift_tm"][i] = ns["shift_tm"]
            gc["shift_cm"][i] = _gather_last_valid(x2, valid_len)
    return h, (cand if is_verify else gc)


def _attn_layer_fwd(lp, cfg, h, ai: AttnInputs):
    fwd = mla_fwd if cfg.mla else gqa_fwd
    a, nk, nv = fwd(lp["attn"], cfg, rms_norm(h, lp["norm1"], cfg.rms_eps),
                    ai)
    h = h + a
    x2 = rms_norm(h, lp["norm2"], cfg.rms_eps)
    f = moe_fwd(lp["moe"], cfg, x2) if "moe" in lp else mlp_fwd(lp["mlp"], x2)
    return h + f, nk, nv


@torch.no_grad()
def forward(params, cfg: ModelConfig, inputs, positions, *, mode: str = "full",
            cache=None, cache_len=None, tree_mask=None, block_table=None,
            valid_len=None, want_logits: bool = True) -> ModelOutputs:
    """inputs: (B,T) int tokens; positions: (B,T) absolute positions.

    mode='full':   causal over the T tokens, whose positions are
                   consecutive (a prefill from 0).  If ``cache`` is given
                   it is filled at positions [0, T) in place and returned.
                   With ``cache_len`` (B,) as well, the T tokens are one
                   chunk at ``cache_len + arange(T)`` (``positions``):
                   attention caches (dense, or pools with
                   ``block_table``) are written there and attended over
                   through K3's chunk form; recurrent groups scan on from
                   the states in ``cache``.
    mode='verify': T speculative tokens against the populated cache;
                   ``cache_len`` (B,) is the committed length, ``tree_mask``
                   (T,T) the ancestor mask (None => chain).  ``block_table``
                   (B, M) int32 switches the attention caches to the pool
                   layout ``(L, N, bs, Hkv, D)``, streamed by the paged
                   kernel.  An RWKV6 group returns per-token candidate
                   states in the returned cache instead (see above).

    ``valid_len`` (B,), full mode only, counts the non-pad tokens.
    Attention needs no mask for right-pads (causality hides them); an
    RWKV6 group length-masks its scan, so the state is carried past the
    pads unchanged, and takes its final states at ``valid_len - 1``.
    """
    if mode not in ("full", "verify"):
        raise ValueError(f"mode must be 'full' or 'verify': {mode}")
    is_verify = mode == "verify"
    is_chunk = not is_verify and cache is not None and cache_len is not None
    if is_verify and (cache is None or cache_len is None):
        raise ValueError("verify mode needs a cache and cache_len")
    if block_table is not None and not (is_verify or is_chunk):
        raise ValueError("the paged layout needs verify mode or a prefill "
                         "continuation")
    T = inputs.shape[1]
    h = params["embed"][inputs.long()]

    out_cache = list(cache) if cache is not None else None
    layer_offset = 0
    for gi, (kind, n) in enumerate(group_program(cfg)):
        gp = params["groups"][gi]
        gc = cache[gi] if cache is not None else None
        if kind == "rwkv_stack":
            h, new = _rwkv_group_fwd(gp, cfg, h, n, gc, is_verify=is_verify,
                                     valid_len=valid_len)
            if out_cache is not None:
                out_cache[gi] = new
            layer_offset += n
            continue
        windows = _window_array(cfg, n, layer_offset)
        # the choice of paged kernel is per GROUP, as in JAX: a group with
        # any sliding-window layer runs K4 on all its layers
        win_group = group_has_window(cfg, layer_offset, n)
        cached = is_verify or is_chunk
        for i in range(n):
            ai = AttnInputs(
                q_pos=positions,
                cache_k=gc["k"][i] if cached else None,
                cache_v=gc["v"][i] if cached else None,
                cache_len=cache_len if cached else None,
                tree_mask=tree_mask if is_verify else None,
                window=windows[i], causal=True,
                block_table=block_table, windowed=win_group,
                prefill=is_chunk)
            h, nk, nv = _attn_layer_fwd(layer(gp, i), cfg, h, ai)
            if gc is not None and not cached:     # prefill: write [0, T)
                gc["k"][i, :, :T] = nk.to(gc["k"].dtype)
                gc["v"][i, :, :T] = nv.to(gc["v"].dtype)
        layer_offset += n

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h.float() @ params["unembed_f32"] if want_logits else None
    return ModelOutputs(hidden=h, logits=logits, cache=out_cache)
