"""Cache commit for speculative decoding (port of
``repro/serving/cache.py``).

After a verify forward the caches hold *candidates*:

* attention groups (``k``/``v``): all T tree tokens in the scratch region
  [len, len+T); commit compacts the accepted root-path entries to
  [len, len+n_accept+1).  Nothing below ``cache_len`` is touched;
* recurrent-state groups (RWKV6's ``wkv_state``/``shift_tm``/
  ``shift_cm``, Mamba2's ``ssd_state``/``conv_win``): a separate
  per-token candidate tensor ``(L, B, T, ...)`` per key; commit selects
  the candidate of the last accepted node, ``path_nodes[n_accept]``, and
  writes it into the committed state.  Both are gathers, no recompute.

Commit addresses the cache in LOGICAL coordinates either way.  Dense
(``block_table`` None): each array is the per-slot ``(L, B, S, ...)`` view.
Paged: each array is the global pool ``(L, N, bs, ...)`` and the (B, M)
block table translates the same logical src/dst positions to (physical
block, offset) pairs.

The port commits IN PLACE.  The source range ``len + path`` and the
destination range ``len + arange`` overlap, so the move must read every
source before it writes any destination: ``arr[dst] = arr[src]`` does,
because advanced indexing on the right copies the gathered entries into a
new tensor before the scatter runs.  A fused in-place copy would not.
Rows that are not live need no masking in an attention group: their
writes stay in their own scratch region beyond the frozen ``cache_len``
(or, paged with an all-NULL table, in the NULL block), which no later step
reads unmasked.  A state group REPLACES the committed state, so there only
the live rows (``active``) take their candidate, and the others keep
theirs, as JAX's restore from ``prev`` does.  A one-node path (the
autoregressive step) moves no attention entry: its source and destination
are both ``cache_len``, so attention groups are left as they are.
"""
from __future__ import annotations

import torch

ATTN_KEYS = frozenset({"k", "v"})


def _commit_attn(arr, cache_len, path_nodes, *, block_table=None):
    """Gather accepted tree slots to the front of the scratch region, in
    place.  arr: dense (L,B,S,...), or with ``block_table`` the pool
    (L,N,bs,...)."""
    D1 = path_nodes.shape[1]
    ar = torch.arange(D1, device=path_nodes.device)[None, :]
    base = cache_len[:, None].long()
    if block_table is None:
        B, S = arr.shape[1:3]
        bidx = torch.arange(B, device=arr.device)[:, None]
        src = torch.clamp_max(base + path_nodes, S - 1)         # (B,D1)
        dst = torch.clamp_max(base + ar, S - 1)
        arr[:, bidx, dst] = arr[:, bidx, src]
    else:
        bs = arr.shape[2]
        cap = block_table.shape[1] * bs
        table = block_table.long()
        src = torch.clamp_max(base + path_nodes, cap - 1)
        dst = torch.clamp_max(base + ar, cap - 1)
        sblk = torch.gather(table, 1, src // bs)                 # (B,D1)
        dblk = torch.gather(table, 1, dst // bs)
        # released rows hold all-NULL tables: their writes collide inside
        # the shared garbage block, which is never read unmasked
        arr[:, dblk, dst % bs] = arr[:, sblk, src % bs]
    return arr


def _commit_state(dst, cand, last_node, active):
    """In place: dst[:, b] = cand[:, b, last_node[b]] where ``active[b]``
    (every row when None); the other rows keep dst's value.  dst:
    committed (L, B, ...); cand: (L, B, T, ...).  No host read-back."""
    B, T = cand.shape[1:3]
    bidx = torch.arange(B, device=cand.device)
    sel = cand[:, bidx, torch.clamp_max(last_node.long(), T - 1)]
    if active is None:
        dst.copy_(sel)
    else:
        live = active.view((1, B) + (1,) * (sel.dim() - 2))
        torch.where(live, sel.to(dst.dtype), dst, out=dst)


def commit_cache(cache, cache_len, path_nodes, n_accept=None, *,
                 active=None, prev=None, block_table=None):
    """Commit a verify forward's ``cache`` (its candidates); returns the
    committed cache.

    Attention groups are compacted in place and returned as they are.  A
    recurrent-state group needs ``n_accept`` (B,) and ``prev``, the
    pre-verify committed cache: the candidate at ``path_nodes[n_accept]``
    is written into ``prev``'s tensors in place, for the rows of
    ``active`` (B,) bool only (all rows when None), and ``prev``'s group
    is returned."""
    out = []
    last_node = None
    for gi, group in enumerate(cache):
        if ATTN_KEYS.issuperset(group):
            if path_nodes.shape[1] > 1:
                for arr in group.values():
                    _commit_attn(arr, cache_len, path_nodes,
                                 block_table=block_table)
            out.append(group)
            continue
        if n_accept is None or prev is None:
            raise ValueError("committing a state group needs n_accept and "
                             "prev (the pre-verify committed cache)")
        if last_node is None:
            last_node = torch.gather(path_nodes, 1,
                                     n_accept.long()[:, None])[:, 0]
        for key, cand in group.items():
            _commit_state(prev[gi][key], cand, last_node, active)
        out.append(prev[gi])
    return out
