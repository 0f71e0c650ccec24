"""Paged KV cache: block tables over a global block pool (port of
``repro/serving/paged.py``).

Attention caches live in a global **block pool** per cache array,
``(L, num_blocks, block_size, Hkv, D)`` (``(L, num_blocks, block_size, r)``
and ``(..., rd)`` for MLA's latent and rope key), instead of
``(L, B, max_len, ...)`` per-slot stripes; a per-slot **block table** ``(B, blocks_per_slot)`` maps
logical token-block j of a slot to a physical pool block.  The Hydra++
PrefixAttention cache rides the same tables in pools of its own.

Recurrent-state groups (RWKV6's ``rwkv_stack``, Mamba2's ``mamba_stack``)
have nothing to page: their keys keep the dense per-slot layout
``(L, max_batch, ...)`` in the pool state, and the engine's block
accounting runs as for any model (blocks are allocated and freed; for a
pure recurrent stack nothing reads them), as in the JAX engine.  Exactly
the attention groups (``models/model.py::attention_group``: the
attention stacks and zamba2's ``shared_attn`` invocations, each a pool of
its own behind the one block table) are paged.

Physical block 0 is the reserved **NULL block**: every unallocated table
entry points at it.  It accumulates garbage writes (inactive rows'
scratch, warm-up steps) and is never read: the paged kernel skips NULL
table entries outright.

The step runs natively: ``paged_spec_decode_step`` hands the pools and
the block table to ``spec_decode_step``, whose verify forward streams
K/V blocks through the paged tree-verify kernel and whose commit compacts
accepted entries through the table.  Join (``paged_join_slot``) prefills
one request into a fresh row and scatters its [0, P) entries through the
slot's table row; a chunked join (``paged_join_slot_chunk``) writes each
chunk through the table from inside the forward, so the engine allocates
blocks one chunk at a time.  The host-side ``BlockAllocator`` lives here too; the
serving policy around it is ``serving/engine.py::PagedSpeculativeEngine``.
"""
from __future__ import annotations

import heapq
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.heads import init_prefix_cache, prefix_forward
from repro_torch.core.speculative import (DecodeState, StepResult,
                                          autoregressive_step, carried_state,
                                          chunk_operands, install_chunk,
                                          prefill_row, spec_decode_step)
from repro_torch.device import torch_dtype
from repro_torch.models.model import (attention_group, forward,
                                      group_cache, group_program)
from repro_torch.serving.cache import ATTN_KEYS

NULL_BLOCK = 0


# ---------------------------------------------------------------------------
# host-side block allocator
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Allocator over the global block pool (host side).

    Block ids are ``[1, num_blocks)``: physical block 0 is the reserved
    NULL block and is never handed out.  ``alloc`` is all-or-nothing: a
    request for more blocks than are free returns ``None`` and changes
    nothing, which lets the engine turn exhaustion into queueing or
    preemption.  The free pool is a min-heap mirrored by a membership set:
    ``free`` raises ``ValueError`` on a double or foreign free, and
    ``alloc`` hands out the lowest free ids first, which keeps block
    placement deterministic.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is the reserved NULL)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # ascending list == valid min-heap; heappop hands out 1, 2, ...
        self._free_heap: List[int] = list(range(1, num_blocks))
        self._allocated: set = set()
        self.peak_in_use = 0

    @property
    def usable_blocks(self) -> int:
        """Pool capacity excluding the NULL block."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free_heap)

    @property
    def blocks_in_use(self) -> int:
        return len(self._allocated)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cover ``n_tokens`` logical cache positions."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free_heap):
            return None
        got = [heapq.heappop(self._free_heap) for _ in range(n)]
        self._allocated.update(got)
        self.peak_in_use = max(self.peak_in_use, len(self._allocated))
        return got

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise ValueError(f"double/foreign free of block {b}")
            self._allocated.discard(b)
            heapq.heappush(self._free_heap, b)


# ---------------------------------------------------------------------------
# device-side pool state
# ---------------------------------------------------------------------------


class PagedState(NamedTuple):
    """DecodeState with the attention caches in pool layout.  The block
    table is NOT part of the state: the engine owns it host-side and
    passes a copy into each step."""

    pools: Any                             # [{"k","v": (L, N, bs, Hkv, D)}]
    #                                        or per-slot state (L, B, ...)
    prefix_k: Optional[torch.Tensor]       # (N, bs, Hkv, D) or None
    prefix_v: Optional[torch.Tensor]
    cache_len: torch.Tensor                # (B,) int32
    last_token: torch.Tensor               # (B,) int64
    last_hidden: torch.Tensor              # (B, d)


def init_paged_state(params, draft_params, cfg: ModelConfig, max_batch: int,
                     num_blocks: int, block_size: int, device) -> PagedState:
    """Empty paged pool, every row idle.  Each group's cache is made once,
    in its own layout: an attention group's with (batch=num_blocks,
    max_len=block_size), exactly the pool shape, a recurrent group's with
    (batch=max_batch), the per-slot shape of keys that carry no sequence
    axis."""
    pk = pv = None
    if draft_params is not None and "prefix" in draft_params:
        pc = init_prefix_cache(cfg, num_blocks, block_size, device)
        pk, pv = pc["k"], pc["v"]
    pools = [group_cache(cfg, kind, n, num_blocks, block_size, device)
             if attention_group(kind)
             else group_cache(cfg, kind, n, max_batch, 1, device)
             for kind, n in group_program(cfg)]
    return PagedState(
        pools=pools,
        prefix_k=pk, prefix_v=pv,
        cache_len=torch.zeros((max_batch,), dtype=torch.int32, device=device),
        last_token=torch.zeros((max_batch,), dtype=torch.long, device=device),
        last_hidden=torch.zeros((max_batch, cfg.d_model),
                                dtype=torch_dtype(cfg.dtype), device=device))


def _pools_as_state(ps: PagedState) -> DecodeState:
    """Relabel: the pools ARE the step state in the native path
    (spec_decode_step reads the layout off the block table's presence)."""
    return DecodeState(cache=ps.pools, cache_len=ps.cache_len,
                       last_token=ps.last_token, last_hidden=ps.last_hidden,
                       prefix_k=ps.prefix_k, prefix_v=ps.prefix_v)


def _state_as_pools(state: DecodeState) -> PagedState:
    return PagedState(pools=state.cache, prefix_k=state.prefix_k,
                      prefix_v=state.prefix_v, cache_len=state.cache_len,
                      last_token=state.last_token,
                      last_hidden=state.last_hidden)


def paged_spec_decode_step(params, draft_params, cfg: ModelConfig, tree,
                           pstate: PagedState, table, *,
                           active: Optional[torch.Tensor] = None,
                           **sampling) -> StepResult:
    """One speculative step over the paged pools: the block table rides
    into ``spec_decode_step`` and the verify forward streams pool blocks
    with the paged kernel; no dense view is ever built.  ``sampling``
    (``criterion``, ``temperature``, ``epsilon``, ``generator``) goes to
    ``spec_decode_step`` as it is."""
    res = spec_decode_step(params, draft_params, cfg, tree,
                           _pools_as_state(pstate), active=active,
                           block_table=table, **sampling)
    return StepResult(_state_as_pools(res.state), res.emitted, res.n_emitted)


def paged_autoregressive_step(params, cfg: ModelConfig, pstate: PagedState,
                              table, *, active: Optional[torch.Tensor] = None,
                              **sampling) -> StepResult:
    """T=1 baseline step over the paged pools (``sampling``: ``greedy``,
    ``temperature``, ``generator``, as ``autoregressive_step`` takes)."""
    res = autoregressive_step(params, cfg, _pools_as_state(pstate),
                              active=active, block_table=table, **sampling)
    return StepResult(_state_as_pools(res.state), res.emitted, res.n_emitted)


def _scatter_rows(pool, rows, table_row, lead: int):
    """pool (lead..., N, bs, tail...) <- rows (lead..., P, tail...) at
    logical positions [0, P) of one slot, through its table row (M,).
    ``lead`` counts the leading axes (1 for a group's layer axis, 0 for the
    prefix pool); the tail is (Hkv, D), or (r,) / (rd,) for MLA.  Positions
    past the row's reach clamp to its last slot; entries pointing at NULL
    land in the garbage block."""
    bs = pool.shape[lead + 1]
    P = rows.shape[lead]
    logical = torch.arange(P, device=pool.device)
    logical = torch.clamp_max(logical, table_row.shape[0] * bs - 1)
    phys = table_row.long()[logical // bs]
    pool[(slice(None),) * lead + (phys, logical % bs)] = rows.to(pool.dtype)


def paged_join_slot(params, draft_params, cfg: ModelConfig,
                    pstate: PagedState, prompt, real_len: int, slot: int,
                    table_row, generator=None, *,
                    greedy: bool = True) -> PagedState:
    """Prefill one request into row ``slot``, writing through the slot's
    (freshly allocated) block-table row (M,) int32, in place.  The engine
    must have pointed ``table_row`` at blocks covering
    ``[0, max(P, real_len + scratch))``: the padded prefill writes [0, P)
    and the next verify step writes scratch at [real_len, real_len + T).
    The first token as in ``core/speculative.py::prefill_row``."""
    row, prefix, tok0, h = prefill_row(params, draft_params, cfg, prompt,
                                       real_len, generator, greedy)
    for pool, r in zip(pstate.pools, row):
        for key, arr in r.items():
            if key in ATTN_KEYS:
                _scatter_rows(pool[key], arr[:, 0], table_row, lead=1)
            else:    # recurrent state: the slot's whole row
                pool[key][:, slot] = arr[:, 0]
    if prefix is not None:
        _scatter_rows(pstate.prefix_k, prefix[0], table_row, lead=0)
        _scatter_rows(pstate.prefix_v, prefix[1], table_row, lead=0)
    pstate.cache_len[slot] = real_len
    pstate.last_token[slot] = tok0
    pstate.last_hidden[slot] = h.to(pstate.last_hidden.dtype)
    return pstate


@torch.no_grad()
def paged_join_slot_chunk(params, draft_params, cfg: ModelConfig,
                          pstate: PagedState, chunk, start: int,
                          real_len: int, slot: int, table_row, *,
                          final: bool, view_blocks: Optional[int] = None,
                          generator=None, greedy: bool = True) -> PagedState:
    """One chunk of a resumable prefill over the paged pools (DESIGN.md
    §8), in place: the paged twin of ``core/speculative.py::
    join_slot_chunk``.  The chunk forward receives the pools and the
    slot's table row (M,) int32 as a (1, M) table and writes the chunk
    K/V token by token through it; attention gathers one layer's logical
    view at a time for K3's chunk form.  Table entries past the
    allocated coverage point at the NULL block, which absorbs the final
    chunk's pad writes; the chunk form never reads them.
    ``view_blocks`` cuts the table row to its first ``view_blocks``
    entries (they must cover ``start + C``), so a chunk gathers only the
    blocks up to its cursor; the masked tail never changes a bit.
    Recurrent-state rows are per slot and scan on from the carried state
    (zeroed for the first chunk).  The final chunk's first token as in
    ``core/speculative.py::install_chunk``."""
    t1 = table_row[:view_blocks][None, :]
    pos, start1, valid = chunk_operands(chunk, start, real_len)
    cache = [{key: (a if key in ATTN_KEYS else carried_state(a, slot, start))
              for key, a in g.items()} for g in pstate.pools]
    out = forward(params, cfg, chunk[None, :], pos, mode="full", cache=cache,
                  cache_len=start1, valid_len=valid, block_table=t1,
                  want_logits=False)
    ph = None
    if draft_params is not None and "prefix" in draft_params:
        ph, _, _ = prefix_forward(
            draft_params, cfg, out.hidden, pos, cache_k=pstate.prefix_k,
            cache_v=pstate.prefix_v, cache_len=start1, block_table=t1,
            prefill=True)
    return install_chunk(params, pstate, out.hidden, ph, start, real_len,
                         slot, final, generator, greedy)
