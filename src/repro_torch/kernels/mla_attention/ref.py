"""Absorbed-MLA paged tree-verify attention (K5): the plain PyTorch
version of the Hopper kernel, with its window hook.

A torch port of ``repro/kernels/attention_template/ref.py::
mla_attention_paged_ref``: the slot's latent and rope-key streams gathered
through the block table, positions of NULL table entries and positions
past ``cache_len`` masked, the T tree latents appended under the (T, T)
ancestor mask; scores ``q_lat . latent + q_rope . rope_key`` times the
caller's ``scale``, ``-inf`` where masked with a NaN -> 0 guard on the
softmax, and the latent as V.  With ``window`` > 0 and ``q_pos``, as the
JAX template's windowed MLA form computes: row t admits cache position k
only if ``q_pos[b, t] - k < window`` and tree key j, at position
``cache_len + j``, only if ``q_pos[b, t] - (cache_len + j) < window``.  A
window <= 0 (or None) is an exact no-op.  fp64 operands are computed in
fp64 (the reference ``chip_smoke.py`` reports the fp32 kernel's
difference from), anything else in fp32.

Excluded positions are removed by selection, never by multiplication:
the gathered latents and rope keys are selected to 0 there (and, with a
window, at positions at or behind ``cache_len - window``, out of every
row's reach since rows sit at ``q_pos >= cache_len``), because ``0 *
NaN`` is NaN and a NULL block may hold NaN or inf.  The CPU tests run it
and ``chip_smoke.py`` holds the kernel against it on the card.

``mla_attention_paged_split`` repeats the kernel's decomposition: the
cache swept in splits of ``split_len`` positions, one partial
``(m, l, acc)`` per query row and split (the empty partial for a split
wholly behind the window, as the kernel skips it), the tree keys' partial
last, folded in that order by ``tree_attention/split.py::fold`` (the
tree-verify kernel's merge rule).  The CPU tests hold it against the
unsplit version and the JAX kernel; the wrapper's CPU path runs the
unsplit one.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.tree_attention import split as _split
from repro_torch.models.layers import work_dtype

NULL_BLOCK = 0                 # physical pool block 0 is never read unmasked


def _windowed(window) -> bool:
    return window is not None and int(window) > 0


def mla_attention_paged_plain(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                              tree_rope, tree_mask, cache_len, block_table, *,
                              scale: float, q_pos=None, window=None):
    """q_lat: (B,T,H,r); q_rope: (B,T,H,rd); pool_lat: (N,bs,r);
    pool_rope: (N,bs,rd); tree_lat: (B,T,r); tree_rope: (B,T,rd);
    tree_mask: (T,T) bool; cache_len: (B,) int; block_table: (B,M) int;
    with ``window`` > 0, q_pos: (B,T) int.  Returns o_lat (B,T,H,r) in
    q_lat's dtype."""
    B, T, H, r = q_lat.shape
    bs = pool_lat.shape[1]
    M = block_table.shape[1]
    S = M * bs
    dev = q_lat.device
    table = block_table.long()
    kv_pos = torch.arange(S, device=dev)
    covered = (table != NULL_BLOCK).repeat_interleave(bs, dim=1)
    in_cache = covered & (kv_pos[None, :] < cache_len[:, None])     # (B,S)
    keep = in_cache
    if _windowed(window):
        keep = keep & (kv_pos[None, :] > cache_len.long()[:, None] - window)
    keep = torch.cat([keep, torch.ones((B, T), dtype=torch.bool,
                                       device=dev)], dim=1)
    wt = work_dtype(q_lat)
    lat = torch.cat([pool_lat[table].reshape(B, S, r),
                     tree_lat.to(pool_lat.dtype)], dim=1)
    rope = torch.cat([pool_rope[table].reshape(B, S, -1),
                      tree_rope.to(pool_rope.dtype)], dim=1)
    lat = torch.where(keep[:, :, None], lat.to(wt), 0.0)           # (B,S+T,r)
    rope = torch.where(keep[:, :, None], rope.to(wt), 0.0)
    s = (torch.einsum("bthr,bsr->bths", q_lat.to(wt), lat)
         + torch.einsum("bthr,bsr->bths", q_rope.to(wt), rope)) * scale
    mask = torch.cat([in_cache[:, None, :].expand(B, T, S),
                      tree_mask[None].expand(B, T, T)], dim=2)      # (B,T,S+T)
    if _windowed(window):
        abs_kv = torch.cat([kv_pos[None, :].expand(B, S),
                            cache_len.long()[:, None]
                            + torch.arange(T, device=dev)[None, :]], dim=1)
        mask = mask & (q_pos.long()[:, :, None] - abs_kv[:, None, :]
                       < window)
    s = torch.where(mask[:, :, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bths,bsr->bthr", p, lat).to(q_lat.dtype)


def mla_attention_paged_split(q_lat, q_rope, pool_lat, pool_rope, tree_lat,
                              tree_rope, tree_mask, cache_len, block_table, *,
                              scale: float, split_len: int, q_pos=None,
                              window=None):
    """K5 by the kernel's split sweep and merge, same operands and result
    as ``mla_attention_paged_plain`` (any T).  Keys the kernel never reads
    (NULL entries, positions at or past ``cache_len``, and with a window
    positions at or behind ``cache_len - window``) are selected to zero
    before any arithmetic; a split that holds none of a slot's reachable
    keys, as one wholly behind the window, leaves the empty partial."""
    B, T, H, r = q_lat.shape
    bs = pool_lat.shape[1]
    M = block_table.shape[1]
    C = M * bs
    dev = q_lat.device
    table = block_table.long()
    pos = torch.arange(C, device=dev)
    lens = cache_len.long()
    ok = (table != NULL_BLOCK).repeat_interleave(bs, dim=1) & (
        pos[None, :] < lens[:, None])                              # (B,C)
    win = _windowed(window)
    if win:
        ok = ok & (pos[None, :] > lens[:, None] - window)
        # row t * H + h sits at q_pos[b, t]
        rows_pos = q_pos.long().repeat_interleave(H, dim=1)[:, None, :,
                                                            None]  # (B,1,R,1)
    keys = torch.cat([pool_lat[table].reshape(B, C, r),
                      pool_rope[table].reshape(B, C, -1)], dim=-1)
    keys = torch.where(ok[:, :, None], keys.float(), 0.0)[:, None]  # (B,1,C,Dk)
    # the kernel's rows: row t*H + h is tree token t of head h
    qf = (torch.cat([q_lat.float(), q_rope.float()], dim=-1)
          .reshape(B, 1, T * H, -1)) * scale
    state = _split.empty_partial((B, 1, T * H), r, dev)
    for s in range(_split.n_splits(C, split_len)):
        lo, hi = s * split_len, min((s + 1) * split_len, C)
        k = keys[:, :, lo:hi]
        mask = ok[:, None, None, lo:hi]
        if win:
            mask = mask & (rows_pos - pos[lo:hi] < window)
        part = _split._partial(qf, k, k[..., :r], mask)
        if win:
            # the kernel's skip: a split whose last live position is at or
            # behind cache_len - window writes the empty partial
            last = torch.clamp(lens, max=hi) - 1
            behind = (last <= lens - window)[:, None, None]          # (B,1,1)
            empty = _split.empty_partial((B, 1, T * H), r, dev)
            part = tuple(torch.where(behind if x.dim() == 3
                                     else behind[..., None], e, x)
                         for x, e in zip(part, empty))
        state = _split.fold(state, part)
    tk = torch.cat([tree_lat.float(), tree_rope.float()], dim=-1)[:, None]
    mask = tree_mask.repeat_interleave(H, dim=0)[None, None]       # (1,1,R,T)
    if win:
        tree_pos = lens[:, None] + torch.arange(T, device=dev)      # (B,T)
        mask = mask & (rows_pos - tree_pos[:, None, None, :] < window)
    state = _split.fold(state, _split._partial(qf, tk, tk[..., :r], mask))
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, T, H, r).to(q_lat.dtype)
