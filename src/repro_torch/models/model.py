"""Model assembly (port of ``repro/models/model.py``).  A model is a
sequence of *groups* (``group_program``); group kinds:

  attn_stack_dense, attn_stack_moe — pre-norm transformer layers (GQA,
                 full-attention or sliding-window, or DeepSeek-V2's MLA;
                 dense or MoE FFN)
  rwkv_stack   — RWKV6 layers (time-mix + channel-mix)
  mamba_stack  — Mamba2 layers (``{norm, mamba}``: pre-norm, SSD mixer)
  shared_attn  — zamba2's shared transformer block: ONE weight set,
                 ``params["shared_attn"]``, invoked once per such group
                 (its ``groups`` entry is an empty dict), each invocation
                 with a KV cache slot of its own

An encoder-only config (hubert-xlarge) is one ``attn_stack_dense`` group
run bidirectionally over frame embeddings ``(B, S, d)``, in full mode and
without a cache: it has no decode path (``init_cache`` refuses it).

The params keep the JAX pytree's layout so the bridge converts one-to-one:
``embed (V, d)``, ``final_norm``, ``lm_head (d, V)`` unless embeddings are
tied, ``mask_embed (d,)`` for an audio config (the masked-prediction
token), one entry of ``groups`` per group (an MoE config has a dense group
of ``n_dense_layers`` and then an MoE group), with every leaf stacked on a
leading layer axis, and ``shared_attn``, one unstacked layer, for zamba2.
One more entry, ``unembed_f32``, holds the fp32 unembedding the logits
multiply with.  JAX upcasts the ``(d, V)`` unembedding on every call; the
port makes that copy once, at load (3.1 GB at minitron-4b, see PERF.md),
and ``refresh_unembed_f32`` copies the params into it again after a
training step; under autograd the logits read the param itself
(``unembedding``), so its gradient reaches ``embed``/``lm_head``.

Caches are a list with one dict per group.  An attention group
(``attention_group``: ``attn_stack*`` and ``shared_attn``) holds ``{"k",
"v"}``: dense ``(L, B, S, Hkv, D)`` per-slot arrays, or — with a block
table — global pools ``(L, N, bs, Hkv, D)``; a ``shared_attn`` group has
L = 1.  An MLA group caches the latent and the rope key instead: ``k`` is
``(L, B|N, S|bs, r)``, ``v`` ``(L, ..., rd)``.  A recurrent group holds
state with no sequence axis, per slot under any layout: RWKV6's
``wkv_state (L, B, H, 64, 64)`` fp32 and the token-shift states
``shift_tm``/``shift_cm (L, B, 1, d)``; Mamba2's ``ssd_state (L, B, H,
ds, hd)`` fp32 and the conv window ``conv_win (L, B, W-1, C)`` in the
model dtype.  ``forward`` updates the attention caches IN PLACE (JAX
returns new arrays) and returns the same tensors; in full mode it writes
a recurrent group's final states in place too, while in verify mode it
leaves the committed state alone and returns, for that group, new
per-token CANDIDATE states (``(L, B, T, ...)``) that
``serving/cache.py::commit_cache`` selects from.

A group with sliding-window layers (gemma3's 5 local : 1 global pattern)
runs its paged verify through the windowed kernel K4, each layer with its
own window (0 for the global layers), as JAX picks the windowed template
variant per group.  An MLA stack runs its paged verify through K5.  An
RWKV6 stack runs its prefill scan through K6, a Mamba2 stack through the
grouped SSD; both run their verify scan (per token, every state kept) in
plain PyTorch, ignoring the tree mask (their trees are chains) and any
block table (they have nothing to page).  zamba2's shared block is a GQA
layer like any other: K1 (paged) or K2 (dense) in verify, K3 in prefill.

Execution modes:
  'full'   — prefill over the whole sequence; fills ``cache`` at [0, T).
             With ``cache`` AND ``cache_len`` it is a chunked-prefill
             continuation (DESIGN.md §8): the T tokens sit at
             ``cache_len + arange(T)``, attention groups write them
             there (dense, or paged through ``block_table``) and attend
             through K3's chunk form, and a recurrent group scans on from
             its carried state (the caller zeroes it for a first chunk)
  'verify' — T speculative tokens (tree or chain) against a populated
             cache; dense, or paged through ``block_table``
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, seeded_generator, torch_dtype
from repro_torch.models.attention import (AttnInputs, gqa_fwd, init_gqa,
                                          init_mla, mla_fwd)
from repro_torch.models.layers import embed_init, init_mlp, mlp_fwd, rms_norm
from repro_torch.models.moe import init_moe, moe_fwd
from repro_torch.models.ssm import (_gather_last_valid, init_mamba2,
                                    init_rwkv6, mamba2_dims, mamba2_fwd,
                                    rwkv6_chanmix, rwkv6_timemix)


class ModelOutputs(NamedTuple):
    hidden: torch.Tensor                 # (B, T, d) final-norm hidden states
    logits: Optional[torch.Tensor]       # (B, T, V) fp32
    cache: Any                           # the (updated in place) cache
    aux_loss: Optional[torch.Tensor] = None  # MoE aux, 0-d fp32 (want_aux)


def group_program(cfg: ModelConfig):
    """Returns a list of (kind, n_layers) describing the stack."""
    if cfg.block_kind == "rwkv6":
        return [("rwkv_stack", cfg.n_layers)]
    if cfg.block_kind == "mamba2":
        every = cfg.hybrid_attn_every
        if not every:
            return [("mamba_stack", cfg.n_layers)]
        groups, done = [], 0
        while done < cfg.n_layers:
            seg = min(every, cfg.n_layers - done)
            groups += [("shared_attn", 1), ("mamba_stack", seg)]
            done += seg
        return groups
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: no group program for block kind {cfg.block_kind}")
    if cfg.moe:
        nd = cfg.moe.n_dense_layers
        out = [("attn_stack_dense", nd)] if nd else []
        out.append(("attn_stack_moe", cfg.n_layers - nd))
        return out
    return [("attn_stack_dense", cfg.n_layers)]


def attention_group(kind: str) -> bool:
    """True for a group whose cache has a sequence axis (``k``/``v``, paged
    under a block table): the attention stacks and zamba2's shared block.
    The recurrent groups' state is per slot under any layout."""
    return kind.startswith("attn_stack") or kind == "shared_attn"


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


def _init_mamba_layer(gen, cfg, dtype, device):
    return {"norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mamba": init_mamba2(gen, cfg, dtype, device)}


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


def unembed_param(params, cfg: ModelConfig):
    """The ``(d, V)`` unembedding param: ``embed.T`` when tied, else
    ``lm_head``."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def add_unembed_f32(params, cfg: ModelConfig):
    """Attach the fp32 unembedding ``(d, V)`` the logits use (one copy,
    made at load; the param itself when it is an fp32 ``lm_head``)."""
    params["unembed_f32"] = unembed_param(params, cfg).float().contiguous()
    return params


@torch.no_grad()
def refresh_unembed_f32(params, cfg: ModelConfig):
    """Copy ``embed``/``lm_head`` into the fp32 unembedding again, in
    place, after a step that trained them (``training/trainer.py`` calls
    it after every base step).  Nothing to do where it is the param."""
    w, u = unembed_param(params, cfg), params["unembed_f32"]
    if u is not w:
        u.copy_(w)
    return params


def unembedding(params, cfg: ModelConfig):
    """The fp32 ``(d, V)`` unembedding logits multiply with: the copy
    made at load, or, where autograd needs the gradient of ``embed`` or
    ``lm_head`` (grad mode on and the param requiring it), the param
    upcast on the spot (the same values, on the graph)."""
    w = unembed_param(params, cfg)
    if torch.is_grad_enabled() and w.requires_grad:
        return w.float()
    return params["unembed_f32"]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Random params drawn on ``device`` from a seeded torch.Generator,
    with the JAX init's distributions (not its numbers).  zamba2's shared
    block is drawn once, into ``params["shared_attn"]``, and every
    ``shared_attn`` group reads it."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    gen = seeded_generator(dev, seed)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, dev).T.contiguous()
    if cfg.modality == "audio":
        params["mask_embed"] = (torch.randn(
            (cfg.d_model,), generator=gen, device=dev) * 0.02).to(dtype)
    layer_init = {
        "rwkv_stack": lambda: _init_rwkv_layer(gen, cfg, dtype, dev),
        "mamba_stack": lambda: _init_mamba_layer(gen, cfg, dtype, dev),
        "attn_stack_dense": lambda: _init_attn_layer(gen, cfg, dtype, dev,
                                                     moe_ffn=False),
        "attn_stack_moe": lambda: _init_attn_layer(gen, cfg, dtype, dev,
                                                   moe_ffn=True)}
    groups = []
    for kind, n in group_program(cfg):
        if kind == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = layer_init["attn_stack_dense"]()
            groups.append({})             # the weights live in the shared slot
        else:
            groups.append(_init_stacked(n, layer_init[kind]))
    params["groups"] = groups
    return add_unembed_f32(params, cfg)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def group_cache(cfg: ModelConfig, kind: str, n: int, batch: int,
                max_len: int, device, dtype=None) -> dict:
    """One group's committed cache, zeros (see ``init_cache``)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
    if kind == "rwkv_stack":
        H, d = cfg.n_heads, cfg.d_model
        hd = d // H
        return {"wkv_state": zeros(n, batch, H, hd, hd, dt=torch.float32),
                "shift_tm": zeros(n, batch, 1, d),
                "shift_cm": zeros(n, batch, 1, d)}
    if kind == "mamba_stack":
        s = cfg.ssm
        _, H, conv_ch = mamba2_dims(cfg)
        return {"ssd_state": zeros(n, batch, H, s.d_state, s.head_dim,
                                   dt=torch.float32),
                "conv_win": zeros(n, batch, s.conv_width - 1, conv_ch)}
    if cfg.mla:
        m = cfg.mla
        return {"k": zeros(n, batch, max_len, m.kv_lora_rank),
                "v": zeros(n, batch, max_len, m.qk_rope_dim)}
    kv = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": zeros(*kv), "v": zeros(*kv)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype=None):
    """Committed cache: one entry per group, zeros.  With
    (batch=num_blocks, max_len=block_size) the attention entries are
    exactly the pool; recurrent-state entries have no sequence axis and
    are per slot (``batch`` rows), so ``max_len`` does not shape them.
    An encoder-only config has no cache (JAX's ``init_cache`` returns
    None for it): it raises."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only: it has no cache and "
                         "no decode path")
    return [group_cache(cfg, kind, n, batch, max_len, device, dtype)
            for kind, n in group_program(cfg)]


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


def _mamba_group_fwd(gp, cfg, h, n: int, gc, *, is_verify: bool,
                     valid_len):
    """A Mamba2 group: pre-norm SSD mixer per layer, from the committed
    states in ``gc`` (zeros when None).  Full mode writes the final states
    into ``gc`` in place (the conv window taken after token ``valid_len -
    1``) and returns it; verify mode returns per-token candidates
    ``{"ssd_state": (L,B,T,H,ds,hd), "conv_win": (L,B,T,W-1,C)}`` and
    leaves ``gc`` alone."""
    B, T, _ = h.shape
    mode = "verify" if is_verify else "full"
    cand = None
    if is_verify:
        s = cfg.ssm
        _, H, conv_ch = mamba2_dims(cfg)
        cand = {"ssd_state": torch.empty((n, B, T, H, s.d_state, s.head_dim),
                                         dtype=torch.float32,
                                         device=h.device),
                "conv_win": torch.empty((n, B, T, s.conv_width - 1, conv_ch),
                                        dtype=h.dtype, device=h.device)}
    for i in range(n):
        lp = layer(gp, i)
        st = layer(gc, i) if gc is not None else {}
        y, ns = mamba2_fwd(lp["mamba"], cfg,
                           rms_norm(h, lp["norm"], cfg.rms_eps), mode=mode,
                           ssd_state=st.get("ssd_state"),
                           conv_state=st.get("conv_win"),
                           valid_len=None if is_verify else valid_len)
        h = h + y
        out = cand if is_verify else gc
        if out is not None:
            for key, val in ns.items():
                out[key][i] = val
    return h, (cand if is_verify else gc)


def _attn_layer_fwd(lp, cfg, h, ai: AttnInputs, want_aux: bool):
    """One pre-norm layer; returns (h, new k, new v, the MoE layer's aux
    loss or None)."""
    fwd = mla_fwd if cfg.mla else gqa_fwd
    a, nk, nv = fwd(lp["attn"], cfg, rms_norm(h, lp["norm1"], cfg.rms_eps),
                    ai)
    h = h + a
    x2 = rms_norm(h, lp["norm2"], cfg.rms_eps)
    aux = None
    if "moe" in lp:
        f, aux = moe_fwd(lp["moe"], cfg, x2, want_aux=want_aux)
    else:
        f = mlp_fwd(lp["mlp"], x2)
    return h + f, nk, nv, aux


def forward(params, cfg: ModelConfig, inputs, positions, *, mode: str = "full",
            cache=None, cache_len=None, tree_mask=None, block_table=None,
            valid_len=None, want_logits: bool = True,
            want_aux: bool = False) -> ModelOutputs:
    """inputs: (B,T) int tokens, or (B,T,d) frame embeddings (an
    encoder's stub frontend; cast to the model dtype); positions: (B,T)
    absolute positions.  Attention is causal unless ``cfg.encoder_only``
    (bidirectional, full mode without a cache).

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
                   kernel.  A recurrent group returns per-token candidate
                   states in the returned cache instead (see above).

    ``valid_len`` (B,), full mode only, counts the non-pad tokens.
    Attention needs no mask for right-pads (causality hides them); a
    recurrent group length-masks its scan, so the state is carried past
    the pads unchanged, and takes its final states at ``valid_len - 1``.

    With ``want_aux`` (set by ``lm_loss``, JAX's only reader of it)
    ``aux_loss`` is the sum of the MoE layers' router load-balance losses,
    0-d fp32, a zero for a config without MoE layers; otherwise it is None
    and no MoE layer computes it, so prefill and the captured step do no
    work for it.

    Grad mode is the caller's: the serving entry points call this under
    ``torch.no_grad()``, the training losses with grad on, where the full
    path's K3 and K6 calls go through their autograd wrappers and every
    other kernel (the verify paths, K3's chunk form) refuses to run.  A
    cache is written in place, so only a cache-free full forward trains.
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
    causal = not cfg.encoder_only
    if not causal and cache is not None:
        raise ValueError(f"{cfg.name} is encoder-only: forward takes no cache")
    T = inputs.shape[1]
    if inputs.dim() == 2:
        h = params["embed"][inputs.long()]
    else:
        h = inputs.to(torch_dtype(cfg.dtype))

    out_cache = list(cache) if cache is not None else None
    aux_terms = []
    layer_offset = 0
    for gi, (kind, n) in enumerate(group_program(cfg)):
        gp = params["groups"][gi]
        gc = cache[gi] if cache is not None else None
        if kind in ("rwkv_stack", "mamba_stack"):
            group_fwd = (_rwkv_group_fwd if kind == "rwkv_stack"
                         else _mamba_group_fwd)
            h, new = group_fwd(gp, cfg, h, n, gc, is_verify=is_verify,
                               valid_len=valid_len)
            if out_cache is not None:
                out_cache[gi] = new
            layer_offset += n
            continue
        shared = kind == "shared_attn"
        if shared:
            # one weight set for every invocation, its own KV slot (L = 1);
            # full attention; it does not advance the layer offset
            gp, windows, win_group = params["shared_attn"], [0], False
        else:
            windows = _window_array(cfg, n, layer_offset)
            # the choice of paged kernel is per GROUP, as in JAX: a group
            # with any sliding-window layer runs K4 on all its layers
            win_group = group_has_window(cfg, layer_offset, n)
        cached = is_verify or is_chunk
        for i in range(n):
            ai = AttnInputs(
                q_pos=positions,
                cache_k=gc["k"][i] if cached else None,
                cache_v=gc["v"][i] if cached else None,
                cache_len=cache_len if cached else None,
                tree_mask=tree_mask if is_verify else None,
                window=windows[i], causal=causal,
                block_table=block_table, windowed=win_group,
                prefill=is_chunk)
            h, nk, nv, aux = _attn_layer_fwd(gp if shared else layer(gp, i),
                                             cfg, h, ai, want_aux)
            if aux is not None:
                aux_terms.append(aux)
            if gc is not None and not cached:     # prefill: write [0, T)
                gc["k"][i, :, :T] = nk.to(gc["k"].dtype)
                gc["v"][i, :, :T] = nv.to(gc["v"].dtype)
        if not shared:
            layer_offset += n

    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h.float() @ unembedding(params, cfg) if want_logits else None
    aux_loss = None
    if want_aux:
        aux_loss = (torch.stack(aux_terms).sum() if aux_terms else
                    torch.zeros((), dtype=torch.float32, device=h.device))
    return ModelOutputs(hidden=h, logits=logits, cache=out_cache,
                        aux_loss=aux_loss)
