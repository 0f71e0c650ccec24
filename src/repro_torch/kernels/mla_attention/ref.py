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
"""
from __future__ import annotations

import math

import torch

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
