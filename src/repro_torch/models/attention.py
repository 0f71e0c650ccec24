"""GQA attention block (port of the GQA half of
``repro/models/attention.py``).

Three branches of ``gqa_fwd``:

* full-seq (prefill): causal attention over the sequence, optionally
  sliding-window, through the prefill kernel K3
  (``kernels/flash_attention``);
* dense verify: T new tokens (a candidate tree or chain) are written into
  the per-slot cache at ``cache_len + arange(T)`` (the commit needs them
  there) and attend to the cache plus themselves: through the dense
  tree-verify kernel K2 (``kernels/tree_attention/dense_ops.py``) for a
  layer of window 0, or, for a sliding-window layer, through
  ``masked_attention`` under ``_verify_mask`` (which carries the window).
  No TPU kernel computes dense windowed verify, so that branch is plain
  PyTorch by design, not a fallback;
* paged verify: the cache is the global block pool ``(N, bs, Hkv, D)``;
  the T new K/V scatter through the block table (``_paged_scatter``) and
  attention streams the pool natively (``_paged_verify_gqa``): through
  the paged tree-verify kernel K1, or, for a group with sliding-window
  layers (``AttnInputs.windowed``), its windowed form K4, which takes the
  layer's window at run time (0 for the group's global layers).

and three of ``mla_fwd`` (DeepSeek-V2 multi-head latent attention: the
cache holds the latent ``c_kv (.., r)`` and the rope key ``(.., rd)``
instead of K/V):

* full-seq (prefill): the latent expanded to per-head K (nd + rd) and V
  (vd), run through K3 at those widths with the scale 1/sqrt(nd + rd);
* dense verify: absorbed attention against the per-slot latent cache
  (``q_nope @ w_uk`` scores the latent directly, the latent is V, and
  ``w_uv`` maps the result back to the head space);
* paged verify: the same absorbed math streaming the two pools through
  the absorbed-MLA kernel K5 (``kernels/mla_attention``).

Unlike JAX, the port writes caches IN PLACE: the verify branches update
the cache/pool tensors they are handed (one layer's view of the stacked
``(L, ...)`` arrays) and return those same tensors.  That saves a copy of
the whole cache per layer; the caller owns the aliasing.

The chunked-prefill continuation (GQA and MLA) is not ported yet
(ROADMAP).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.attention_template.ops import (
    tree_attention_paged_windowed_bshd)
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.mla_attention.ops import mla_attention_paged_bshd
from repro_torch.kernels.tree_attention.dense_ops import tree_attention_bshd
from repro_torch.kernels.tree_attention.ops import tree_attention_paged_bshd
from repro_torch.models.layers import (apply_rope, dense_init,
                                       masked_attention, rope_sincos)


class AttnInputs(NamedTuple):
    """Everything the attention core needs besides x and params."""

    q_pos: torch.Tensor                  # (B, T) absolute positions
    cache_k: Optional[torch.Tensor]      # (B, S, Hkv, D), or the pool
    cache_v: Optional[torch.Tensor]      # (N, bs, Hkv, D) with block_table
    cache_len: Optional[torch.Tensor]    # (B,) valid length
    tree_mask: Optional[torch.Tensor]    # (T, T) ancestor-or-self bool
    window: int                          # 0 => full attention
    causal: bool
    block_table: Optional[torch.Tensor] = None   # (B, M) int32 => pool
    windowed: bool = False               # group has sliding-window layers
    #                                      => paged verify takes K4


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def init_gqa(gen, cfg, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq = cfg.n_heads_padded
    p = {
        "wq": dense_init(gen, d, hq * hd, dtype, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, hq * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dtype,
                              device=device)
    return p


def gqa_fwd(p, cfg, x, ai: AttnInputs):
    """Returns (out (B,T,d), k, v): the new (B,T,Hkv,D) K/V on the
    full-seq path, the updated cache/pool tensors on the verify paths."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.n_heads_padded, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)

    sin, cos = rope_sincos(ai.q_pos, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if ai.cache_k is None:
        # full-sequence path (prefill): the K3 kernel.  Positions are
        # consecutive and aligned across the batch (every prefill starts
        # at 0), so the masks depend on index differences only
        out = flash_attention_bshd(q, k, v, causal=ai.causal,
                                   window=ai.window)
    elif ai.block_table is not None:
        # paged verify: scatter scratch through the table, stream the pool
        out, k, v = _paged_verify_gqa(q, k, v, ai)
    else:
        # dense verify: write the new K/V into the scratch region (the
        # commit compacts them there), then attend: K2 at window 0; a
        # sliding-window layer has no kernel of its own (none on the TPU
        # either) and runs masked_attention under the windowed mask
        _dense_scatter(ai.cache_k, k, ai.cache_len)
        _dense_scatter(ai.cache_v, v, ai.cache_len)
        if ai.window > 0:
            mask = _verify_mask(ai, B, T, ai.cache_k.shape[1])
            out = masked_attention(q, ai.cache_k, ai.cache_v, mask)
        else:
            tm = ai.tree_mask
            if tm is None:   # chain: lower-triangular
                tm = torch.ones((T, T), dtype=torch.bool,
                                device=q.device).tril()
            out = tree_attention_bshd(q, ai.cache_k, ai.cache_v, k, v, tm,
                                      ai.cache_len)
        k, v = ai.cache_k, ai.cache_v
    out = out.reshape(B, T, cfg.n_heads_padded * hd)
    return out @ p["wo"], k, v


def _dense_scatter(cache, new, cache_len):
    """In place: cache[b, cache_len[b] + t] = new[b, t].  Writes past the
    cache's end are dropped, as JAX's out-of-bounds scatter drops them."""
    B, T = new.shape[:2]
    slot = cache_len[:, None] + torch.arange(T, device=new.device)[None, :]
    ok = slot < cache.shape[1]
    bidx = torch.arange(B, device=new.device)[:, None].expand(B, T)
    cache[bidx[ok], slot[ok]] = new[ok].to(cache.dtype)


# ---------------------------------------------------------------------------
# paged (block-pool) verify path
# ---------------------------------------------------------------------------


def _paged_scatter(pool, new, cache_len, block_table):
    """In place: write T per-token entries into the pool at the scratch
    region ``[cache_len, cache_len + T)``, mapped through the block table.
    pool: (N, bs, ...); new: (B, T, ...).  Positions past the table's
    reach clamp to the last logical slot (the engine guarantees coverage
    for live rows; dead rows' tables are all-NULL, so their writes land in
    the reserved garbage block)."""
    bs = pool.shape[1]
    M = block_table.shape[1]
    T = new.shape[1]
    logical = cache_len[:, None] + torch.arange(T, device=new.device)[None, :]
    logical = torch.clamp_max(logical, M * bs - 1).long()
    phys = torch.gather(block_table.long(), 1, logical // bs)       # (B,T)
    pool[phys, logical % bs] = new.to(pool.dtype)
    return pool


def _paged_verify_gqa(q, k, v, ai: AttnInputs):
    """Pool-layout verify for GQA: persist the T new K/V through the block
    table (token-granular scatter, the only writes of the step), then
    attend with the paged tree-verify kernel: K4 for a group with
    sliding-window layers (``ai.windowed``; the layer's window and the
    query positions ride along, and a window of 0 is an exact no-op), K1
    otherwise.  This is the single dispatch point of paged attention:
    every paged layer (the base stack and the Hydra++ prefix layer) comes
    through here.  The kernel reads the pool only below ``cache_len`` and
    takes the T new K/V as its tree operands, so the entries just
    scattered are counted once."""
    T = q.shape[1]
    npk = _paged_scatter(ai.cache_k, k, ai.cache_len, ai.block_table)
    npv = _paged_scatter(ai.cache_v, v, ai.cache_len, ai.block_table)
    tm = ai.tree_mask
    if tm is None:   # chain: lower-triangular
        tm = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    if ai.windowed:
        out = tree_attention_paged_windowed_bshd(
            q, npk, npv, k, v, tm, ai.cache_len, ai.block_table, ai.q_pos,
            ai.window)
    else:
        out = tree_attention_paged_bshd(q, npk, npv, k, v, tm, ai.cache_len,
                                        ai.block_table)
    return out, npk, npv


def _verify_mask(ai: AttnInputs, B: int, T: int, S: int):
    """(B, T, S) mask: past-cache causal+window plus tree ancestor block."""
    dev = ai.cache_len.device
    kv_pos = torch.arange(S, device=dev)
    in_past = kv_pos[None, :] < ai.cache_len[:, None]                 # (B,S)
    j = kv_pos[None, :] - ai.cache_len[:, None]                       # (B,S)
    in_tree = (j >= 0) & (j < T)
    jc = torch.clamp(j, 0, T - 1)
    if ai.tree_mask is not None:
        tm = ai.tree_mask
    else:  # chain: lower-triangular
        tm = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
    tree_bit = tm[:, jc].permute(1, 0, 2)                             # (B,T,S)
    mask = (in_past[:, None, :] & ~in_tree[:, None, :]) | (
        in_tree[:, None, :] & tree_bit)
    if ai.window > 0:
        mask &= ai.q_pos[:, :, None] - kv_pos[None, None, :] < ai.window
    return mask


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank KV latent cache + decoupled RoPE key.  The
# cache stores c_kv (.., r) as "k" and k_rope (.., rd) as "v".
# ---------------------------------------------------------------------------


def init_mla(gen, cfg, dtype, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    nd, rd, vd, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    return {
        "w_dq": dense_init(gen, d, H * (nd + rd), dtype, device),
        "w_dkv": dense_init(gen, d, r, dtype, device),
        "w_krope": dense_init(gen, d, rd, dtype, device),
        "w_uk": dense_init(gen, r, H * nd, dtype, device),
        "w_uv": dense_init(gen, r, H * vd, dtype, device),
        "wo": dense_init(gen, H * vd, d, dtype, device),
    }


def mla_fwd(p, cfg, x, ai: AttnInputs):
    """Returns (out (B,T,d), c_kv, k_rope): the new (B,T,r) and (B,T,rd)
    latents on the full-seq path, the updated cache/pool tensors on the
    verify paths."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    nd, rd, vd, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank

    q = (x @ p["w_dq"]).reshape(B, T, H, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_kv = x @ p["w_dkv"]                                   # (B,T,r)
    k_rope = x @ p["w_krope"]                               # (B,T,rd)

    sin, cos = rope_sincos(ai.q_pos, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0, :]

    scale = 1.0 / math.sqrt(nd + rd)

    if ai.cache_k is None:
        # prefill: expand the latent to full K/V, attend through K3
        k_nope = (c_kv @ p["w_uk"]).reshape(B, T, H, nd)
        v = (c_kv @ p["w_uv"]).reshape(B, T, H, vd)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, rd)],
                      dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = _mla_prefill_attention(q_full, k, v, ai, scale)
        return out.reshape(B, T, H * vd) @ p["wo"], c_kv, k_rope

    w_uk = p["w_uk"].reshape(r, H, nd).float()
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), w_uk)  # (B,T,H,r)
    if ai.block_table is not None:
        # paged: scatter the T new latents through the table, then K5
        # streams the latent + rope pools as the K concat and the latent
        # as V, returning o_lat
        table = ai.block_table
        new_k = _paged_scatter(ai.cache_k, c_kv, ai.cache_len, table)
        new_v = _paged_scatter(ai.cache_v, k_rope, ai.cache_len, table)
        tm = ai.tree_mask
        if tm is None:   # chain: lower-triangular
            tm = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        o_lat = mla_attention_paged_bshd(
            q_lat, q_rope.float(), new_k, new_v, c_kv, k_rope, tm,
            ai.cache_len, table, scale=scale,
            q_pos=ai.q_pos if ai.windowed else None,
            window=ai.window if ai.windowed else None)
    else:
        # dense: write the new latents into the scratch region, attend
        # absorbed against the latent cache
        S = ai.cache_k.shape[1]
        _dense_scatter(ai.cache_k, c_kv, ai.cache_len)
        _dense_scatter(ai.cache_v, k_rope, ai.cache_len)
        new_k, new_v = ai.cache_k, ai.cache_v
        mask = _verify_mask(ai, B, T, S)
        ckv = new_k.float()
        s = (torch.einsum("bthr,bsr->bths", q_lat, ckv)
             + torch.einsum("bthr,bsr->bths", q_rope.float(), new_v.float()))
        s = torch.where(mask[:, :, None, :], s * scale, -math.inf)
        pw = torch.softmax(s, dim=-1)
        pw = torch.where(torch.isnan(pw), 0.0, pw)
        o_lat = torch.einsum("bths,bsr->bthr", pw, ckv)
    w_uv = p["w_uv"].reshape(r, H, vd).float()
    out = torch.einsum("bthr,rhv->bthv", o_lat, w_uv)
    out = out.reshape(B, T, H * vd).to(x.dtype)
    return out @ p["wo"], new_k, new_v


def _mla_prefill_attention(q, k, v, ai: AttnInputs, scale: float):
    """q/k (B,S,H,nd+rd) and v (B,S,H,vd) through K3 at their own widths
    (deepseek-v2-lite: 192 and 128) with the given scale; returns
    (B,S,H,vd)."""
    return flash_attention_bshd(q, k, v, causal=ai.causal, window=ai.window,
                                scale=scale)
