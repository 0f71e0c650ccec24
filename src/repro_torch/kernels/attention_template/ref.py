"""Sliding-window paged tree-verify attention (K4): the plain PyTorch
version of the Hopper kernel.

A torch port of ``repro/kernels/attention_template/ref.py::
tree_attention_paged_windowed_ref`` in the model layout: the slot's
logical view gathered through the block table, NULL-table positions and
positions past ``cache_len`` masked, and, with ``window > 0``, every key
at ``window`` or more positions behind a query row's ``q_pos`` masked for
that row (tree token j sits at ``cache_len + j``).  A window <= 0 is an
exact no-op, as in the kernel: the result is K1's plain version's
(``tree_attention/kernel.py::tree_attention_paged_plain``), bit for bit.

Excluded positions are removed by selection, never by multiplication:
scores become -inf and weights 0 through ``torch.where``, and each row's
V is selected to 0 where that row may not look, because ``0 * NaN`` is
NaN and a pool position behind the window may hold anything.  The CPU
tests run it and ``chip_smoke.py`` holds the kernel against it on the
card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.tree_attention.kernel import (
    NULL_BLOCK, tree_attention_paged_plain)
from repro_torch.models.layers import work_dtype


def tree_attention_paged_windowed_plain(q, pool_k, pool_v, tree_k, tree_v,
                                        tree_mask, cache_len, block_table,
                                        q_pos, window: int):
    """q: (B,T,Hq,D); pool_k/v: (N,bs,Hkv,D); tree_k/v: (B,T,Hkv,D);
    tree_mask: (T,T) bool; cache_len: (B,) int; block_table: (B,M) int;
    q_pos: (B,T) int absolute query positions; window: int (<= 0 off).
    Returns (B,T,Hq,D) in q's dtype, computed in fp32 (fp64 for fp64
    operands)."""
    if window <= 0:
        return tree_attention_paged_plain(q, pool_k, pool_v, tree_k, tree_v,
                                          tree_mask, cache_len, block_table)
    B, T, Hq, D = q.shape
    bs, Hkv = pool_k.shape[1], pool_k.shape[2]
    M = block_table.shape[1]
    G = Hq // Hkv
    S = M * bs
    dev = q.device
    table = block_table.long()
    kv_pos = torch.arange(S, device=dev)
    covered = (table != NULL_BLOCK).repeat_interleave(bs, dim=1)
    in_cache = covered & (kv_pos[None, :] < cache_len[:, None])     # (B,S)
    mask = torch.cat([in_cache[:, None, :].expand(B, T, S),
                      tree_mask[None].expand(B, T, T)], dim=2)      # (B,T,S+T)
    abs_kv = torch.cat([kv_pos[None, :].expand(B, S),
                        cache_len[:, None].long()
                        + torch.arange(T, device=dev)[None, :]], dim=1)
    mask = mask & (q_pos.long()[:, :, None] - abs_kv[:, None, :] < window)
    wt = work_dtype(q)
    kx = torch.cat([pool_k[table].reshape(B, S, Hkv, D), tree_k],
                   dim=1).to(wt)                                    # (B,S+T,..)
    vx = torch.cat([pool_v[table].reshape(B, S, Hkv, D), tree_v],
                   dim=1).to(wt)
    m5 = mask[:, :, None, None, :]
    qf = q.to(wt).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bthgs", qf, kx) / math.sqrt(D)
    s = torch.where(m5, s, -math.inf)
    p = torch.where(m5, torch.softmax(s, dim=-1), 0.0)
    v_row = torch.where(mask[:, :, :, None, None], vx[:, None], 0.0)
    out = torch.einsum("bthgs,btshd->bthgd", p, v_row)
    return out.reshape(B, T, Hq, D).to(q.dtype)
