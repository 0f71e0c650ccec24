"""Cache commit for speculative decoding (port of the attention half of
``repro/serving/cache.py``).

After a verify forward the attention caches hold all T tree tokens in the
scratch region [len, len+T); commit compacts the accepted root-path
entries to [len, len+n_accept+1).  Nothing below ``cache_len`` is touched.

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
Rows that are not live need no masking: their writes stay in their own
scratch region beyond the frozen ``cache_len`` (or, paged with an all-NULL
table, in the NULL block), which no later step reads unmasked.
"""
from __future__ import annotations

import torch


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


def commit_cache(cache, cache_len, path_nodes, *, block_table=None):
    """Compact every attention array of a verify forward's cache (in
    place); returns the same cache."""
    for group in cache:
        for key in ("k", "v"):
            _commit_attn(group[key], cache_len, path_nodes,
                         block_table=block_table)
    return cache
