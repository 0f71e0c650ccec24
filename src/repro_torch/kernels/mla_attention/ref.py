"""Absorbed-MLA paged tree-verify attention (K5): the plain PyTorch
version of the Hopper kernel.

A torch port of ``repro/kernels/attention_template/ref.py::
mla_attention_paged_ref``: the slot's latent and rope-key streams gathered
through the block table, positions of NULL table entries and positions
past ``cache_len`` masked, the T tree latents appended under the (T, T)
ancestor mask; scores ``q_lat . latent + q_rope . rope_key`` times the
caller's ``scale``, ``-inf`` where masked with a NaN -> 0 guard on the
softmax, and the latent as V.

Excluded positions are removed by selection, never by multiplication:
the gathered latents and rope keys are selected to 0 there, because
``0 * NaN`` is NaN and a NULL block may hold NaN or inf.  The CPU tests
run it and ``chip_smoke.py`` holds the kernel against it on the card.

``mla_attention_paged_split`` repeats the kernel's decomposition: the
cache swept in splits of ``split_len`` positions, one partial
``(m, l, acc)`` per query row and split, the tree keys' partial last,
folded in that order by ``tree_attention/split.py::fold`` (the tree-verify
kernel's merge rule).  The CPU tests hold it against the unsplit version
and the JAX kernel; the wrapper's CPU path runs the unsplit one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.tree_attention import split as _split

NULL_BLOCK = 0                 # physical pool block 0 is never read unmasked


def mla_attention_paged_plain(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                              tree_rope, tree_mask, cache_len, block_table, *,
                              scale: float):
    """q_lat: (B,T,H,r); q_rope: (B,T,H,rd); pool_lat: (N,bs,r);
    pool_rope: (N,bs,rd); tree_lat: (B,T,r); tree_rope: (B,T,rd);
    tree_mask: (T,T) bool; cache_len: (B,) int; block_table: (B,M) int.
    Returns o_lat (B,T,H,r) in q_lat's dtype."""
    B, T, H, r = q_lat.shape
    bs = pool_lat.shape[1]
    M = block_table.shape[1]
    S = M * bs
    table = block_table.long()
    kv_pos = torch.arange(S, device=q_lat.device)
    covered = (table != NULL_BLOCK).repeat_interleave(bs, dim=1)
    in_cache = covered & (kv_pos[None, :] < cache_len[:, None])     # (B,S)
    keep = torch.cat([in_cache, torch.ones((B, T), dtype=torch.bool,
                                           device=q_lat.device)], dim=1)
    lat = torch.cat([pool_lat[table].reshape(B, S, r),
                     tree_lat.to(pool_lat.dtype)], dim=1)
    rope = torch.cat([pool_rope[table].reshape(B, S, -1),
                      tree_rope.to(pool_rope.dtype)], dim=1)
    lat = torch.where(keep[:, :, None], lat.float(), 0.0)           # (B,S+T,r)
    rope = torch.where(keep[:, :, None], rope.float(), 0.0)
    s = (torch.einsum("bthr,bsr->bths", q_lat.float(), lat)
         + torch.einsum("bthr,bsr->bths", q_rope.float(), rope)) * scale
    mask = torch.cat([in_cache[:, None, :].expand(B, T, S),
                      tree_mask[None].expand(B, T, T)], dim=2)      # (B,T,S+T)
    s = torch.where(mask[:, :, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bths,bsr->bthr", p, lat).to(q_lat.dtype)


def mla_attention_paged_split(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                              tree_rope, tree_mask, cache_len, block_table, *,
                              scale: float, split_len: int):
    """K5 by the kernel's split sweep and merge, same operands and result
    as ``mla_attention_paged_plain`` (any T).  Keys the kernel never reads
    (NULL entries, positions at or past ``cache_len``) are selected to
    zero before any arithmetic."""
    B, T, H, r = q_lat.shape
    bs = pool_lat.shape[1]
    M = block_table.shape[1]
    C = M * bs
    table = block_table.long()
    pos = torch.arange(C, device=q_lat.device)
    ok = (table != NULL_BLOCK).repeat_interleave(bs, dim=1) & (
        pos[None, :] < cache_len.long()[:, None])                  # (B,C)
    keys = torch.cat([pool_lat[table].reshape(B, C, r),
                      pool_rope[table].reshape(B, C, -1)], dim=-1)
    keys = torch.where(ok[:, :, None], keys.float(), 0.0)[:, None]  # (B,1,C,Dk)
    # the kernel's rows: row t*H + h is tree token t of head h
    qf = (torch.cat([q_lat.float(), q_rope.float()], dim=-1)
          .reshape(B, 1, T * H, -1)) * scale
    state = _split.empty_partial((B, 1, T * H), r, q_lat.device)
    for s in range(_split.n_splits(C, split_len)):
        lo, hi = s * split_len, min((s + 1) * split_len, C)
        k = keys[:, :, lo:hi]
        state = _split.fold(state, _split._partial(
            qf, k, k[..., :r], ok[:, None, None, lo:hi]))
    tk = torch.cat([tree_lat.float(), tree_rope.float()], dim=-1)[:, None]
    mask = tree_mask.repeat_interleave(H, dim=0)[None, None]       # (1,1,R,T)
    state = _split.fold(state, _split._partial(qf, tk, tk[..., :r], mask))
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, T, H, r).to(q_lat.dtype)
