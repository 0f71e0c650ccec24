"""The split cache sweep of the tree-verify kernel (K1, K4, K2): its
planner and its plain PyTorch version.

The CUDA kernel (``csrc/tree_attention_paged.cu``) gives each (split, row
group, b, kv head) a block of its own: split s covers cache positions
``[s * split_len, (s + 1) * split_len)`` below ``cache_len`` and leaves a
partial ``(m, l, acc)`` per query row (running max, denominator, unnormalised
output); one more block per (row group, b, kv head) does the T tree keys
under the ancestor mask.  A row group is ``ROW_GROUP`` of the R = G*T
query rows of a kv head, so any R is taken (``row_groups``).  A merge then folds the partials in split order, then the
tree partial, and divides.  No atomics, so a call is bitwise the same from
run to run.

``plan_split_len`` is the host's rule for ``split_len``.  It depends on
the blocks of a split column, B*Hkv times the row groups, alone: never on
``cache_len``, which stays on the device, nor on the capacity, nor on the
pool block size (a paged split may start and end inside a pool block; the
kernel clamps each block's keys to the split).  So a paged call and a
dense call of equal shapes split at the same positions, whatever the
block size.

``plan_mla_split_len`` is the same kind of rule for K5, the absorbed-MLA
paged verify kernel, which sweeps one latent stream in splits and merges
them the same way (its plain version:
``kernels/mla_attention/ref.py::mla_attention_paged_split``).

``tree_attention_paged_split`` and ``tree_attention_dense_split`` repeat
the kernel's split and merge in plain PyTorch: the CPU tests hold them
against the unsplit plain versions (``kernel.py``,
``attention_template/ref.py``) and the JAX kernels.  The wrappers' CPU
path runs the unsplit versions.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30                    # a masked score; the empty partial's max
SPLIT_UNIT = 64                # split_len is a multiple of this
SPLIT_HEADS = 32               # B*Hkv from which a split grows (x2 per x2)
SPLIT_MAX_UNITS = 16
ROW_GROUP = 64                 # query rows a split block holds (K1/K4/K2, K5)


def row_groups(rows: int) -> int:
    """Blocks that hold ``rows`` query rows, ``ROW_GROUP`` each: the
    tree-verify kernel's per (b, kv head) for its G*T rows, K5's per slot
    for its H*T."""
    return -(-rows // ROW_GROUP)


def plan_split_len(B: int, Hkv: int, groups: int = 1) -> int:
    """Cache positions per split: 64 while a split column holds fewer than
    64 blocks, B*Hkv*groups (gemma3-1b's 4 and minitron-4b's 32, one row
    group each), doubling with each doubling past that, up to 1024, so the
    grid fills the card's 132 SMs at a short cache without spending more on
    partials than a long one needs.  Paged and dense calls alike: no block
    size enters.

    ``groups`` (``row_groups(G*T)``) counts as blocks because a row group
    is one: it takes SM time beside the others and writes R*D fp32 of
    partials per split, as a kv head does, so at 80-144 rows (qwen2.5-32b,
    chameleon-34b, starcoder2-7b) the partials double or triple while the
    keys per split stay.  On the card the longer split this gives
    qwen2.5-32b and chameleon-34b (128 against 64 at B = 4) is the faster
    one for K1 and K2 alike (``chip_smoke.py`` phase 3i,
    ``time_split_rules``; PERF.md section 6).  At R <= 64 (one group)
    every split is what it was before row groups."""
    units = 1
    while units < SPLIT_MAX_UNITS and \
            B * Hkv * groups >= SPLIT_HEADS * 2 * units:
        units *= 2
    return SPLIT_UNIT * units



def plan_mla_split_len(B: int, H: int, T: int, r: int, rd: int) -> int:
    """K5's split (``csrc/mla_attention_paged.cu``): cache positions per
    split of the one latent stream, a power-of-two multiple of 64.

    A split of L keys leaves one partial per query row, r fp32 columns,
    written once and read once by the merge: 2 * R * r * 4 bytes for the
    R = H*T rows of a slot.  Packing the H heads into blocks of 64 rows
    reads the stream once per row group instead of once per head, saving
    (H - groups) * L * (r + rd) * 2 bytes on that split (bf16 pools, the
    serving type).  The split is the least multiple of 64 whose partials
    cost no more than that saving, so the split's own traffic never undoes
    the packing (128 at deepseek-v2-lite: 16 heads x T = 16, 4 groups),
    and it doubles with the grid (B * groups) as ``plan_split_len`` does
    with B*Hkv, up to 1024.  Like the tree-verify planner it never reads
    ``cache_len``, nor the pool's block size."""
    R = H * T
    groups = row_groups(R)
    saved_per_key = (H - groups) * (r + rd) * 2
    partials = 2 * R * r * 4
    units = 1
    while units < SPLIT_MAX_UNITS and (
            saved_per_key <= 0
            or saved_per_key * SPLIT_UNIT * units < partials
            or B * groups >= SPLIT_HEADS * 2 * units):
        units *= 2
    return SPLIT_UNIT * units


def n_splits(capacity: int, split_len: int) -> int:
    """Splits that cover ``capacity`` cache positions (the kernel's grid)."""
    return -(-capacity // split_len)


def empty_partial(shape, D: int, device=None):
    """The partial of a split with no live key: m = -1e30, l = 0, acc = 0."""
    return (torch.full(shape, NEG, device=device),
            torch.zeros(shape, device=device),
            torch.zeros((*shape, D), device=device))


def fold(state, part):
    """The running ``(m, l, acc)`` with one more partial folded in, as the
    merge kernel does: both rescaled to the larger max.  An empty partial
    (m = -1e30, l = 0) is an exact identity: its correction is
    exp(-1e30 - m) = 0 and its acc is taken as 0."""
    m, l, acc = state
    ms, ls, accs = part
    mn = torch.maximum(m, ms)
    c, cs = torch.exp(m - mn), torch.exp(ms - mn)
    accs = torch.where((ms == NEG)[..., None], 0.0, accs)
    return mn, l * c + ls * cs, acc * c[..., None] + accs * cs[..., None]


def _partial(qf, k, v, mask):
    """One partial of rows ``qf`` (B, Hkv, R, D), pre-scaled, over keys
    k/v (B, Hkv, n, D) (zero where not loaded) under ``mask``
    (B, Hkv or 1, R, n)."""
    s = torch.where(mask, torch.einsum("bhrd,bhnd->bhrn", qf, k), NEG)
    m = torch.full(s.shape[:-1], NEG, device=s.device)
    if s.shape[-1]:
        m = torch.maximum(m, s.amax(-1))
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhrn,bhnd->bhrd", p, v)


def _split_sweep(q, keys, vals, key_ok, tree_k, tree_v, tree_mask,
                 cache_len, split_len: int, q_pos=None, window: int = 0):
    """q (B,T,Hq,D); keys/vals (B,C,Hkv,D) the slot's cache view of
    capacity C; key_ok (B,C) the positions the kernel loads; tree K/V
    (B,T,Hkv,D), tree_mask (T,T) bool; with ``window`` > 0 and q_pos
    (B,T), row r also needs q_pos[r] - position < window.  Returns
    (B,T,Hq,D) in q's dtype."""
    B, T, Hq, D = q.shape
    C, Hkv = keys.shape[1], keys.shape[2]
    G = Hq // Hkv
    # row r = g*T + t of kv head h is query head h*G + g, tree token t
    qf = (q.float().reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4)
          .reshape(B, Hkv, G * T, D)) / math.sqrt(D)
    ok4 = key_ok[:, :, None, None]
    kx = torch.where(ok4, keys.float(), 0.0).permute(0, 2, 1, 3)
    vx = torch.where(ok4, vals.float(), 0.0).permute(0, 2, 1, 3)
    rows_pos = None
    if window > 0:
        rows_pos = q_pos.long().repeat(1, G)[:, None, :, None]  # (B,1,R,1)
    pos = torch.arange(C, device=q.device)
    state = empty_partial((B, Hkv, G * T), D, q.device)
    for s in range(n_splits(C, split_len)):
        lo, hi = s * split_len, min((s + 1) * split_len, C)
        mask = key_ok[:, None, None, lo:hi]                    # (B,1,1,n)
        if rows_pos is not None:
            mask = mask & (rows_pos - pos[lo:hi] < window)
        state = fold(state, _partial(qf, kx[:, :, lo:hi], vx[:, :, lo:hi],
                                     mask))
    tree_pos = (cache_len.long()[:, None]
                + torch.arange(T, device=q.device))            # (B,T)
    mask = tree_mask.repeat(G, 1)[None, None]                  # (1,1,R,T)
    if rows_pos is not None:
        mask = mask & (rows_pos - tree_pos[:, None, None, :] < window)
    state = fold(state, _partial(qf, tree_k.float().permute(0, 2, 1, 3),
                                 tree_v.float().permute(0, 2, 1, 3), mask))
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]           # (B,Hkv,R,D)
    out = out.reshape(B, Hkv, G, T, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, T, Hq, D).to(q.dtype)


def tree_attention_paged_split(q, pool_k, pool_v, tree_k, tree_v, tree_mask,
                               cache_len, block_table, split_len: int,
                               q_pos=None, window: int = 0):
    """K1 (``window`` <= 0) or K4 by the kernel's split sweep and merge, in
    the model layout, T already padded.  Keys the kernel never reads
    (NULL entries, positions at or past ``cache_len``, and with a window
    positions at or behind ``cache_len - window``) are selected to zero
    before any arithmetic."""
    B = q.shape[0]
    bs, Hkv, D = pool_k.shape[1:]
    M = block_table.shape[1]
    table = block_table.long()
    keys = pool_k[table].reshape(B, M * bs, Hkv, D)
    vals = pool_v[table].reshape(B, M * bs, Hkv, D)
    pos = torch.arange(M * bs, device=q.device)
    ok = (table != 0).repeat_interleave(bs, dim=1) & (
        pos[None, :] < cache_len.long()[:, None])
    if window > 0:
        ok = ok & (pos[None, :] > cache_len.long()[:, None] - window)
    return _split_sweep(q, keys, vals, ok, tree_k, tree_v, tree_mask,
                        cache_len, split_len, q_pos, window)


def tree_attention_dense_split(q, cache_k, cache_v, tree_k, tree_v,
                               tree_mask, cache_len, split_len: int):
    """K2 by the kernel's split sweep and merge: keys of slot b's row below
    ``cache_len[b]``, then the tree keys.  Positions at or past
    ``cache_len`` are never read (selected to zero)."""
    S = cache_k.shape[1]
    ok = (torch.arange(S, device=q.device)[None, :]
          < cache_len.long()[:, None])
    return _split_sweep(q, cache_k, cache_v, ok, tree_k, tree_v, tree_mask,
                        cache_len, split_len)
