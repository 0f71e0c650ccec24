"""The speculative decoding step (port of ``repro/core/speculative.py``).

One ``spec_decode_step`` = draft (a tree, via Medusa/Hydra heads) ->
verify (ONE base-model forward over the T tree tokens) -> accept (greedy
or typical criterion) -> commit caches -> emit tokens.

Randomness: JAX carries a key in its ``DecodeState`` and splits it per
step and per join; the port passes one ``torch.Generator`` (on the
state's device) to every function that samples, and draws are made in
the order the host issues them.  Greedy draws nothing, so a greedy
stream never depends on the generator or the schedule.  Sampling is
Gumbel-max (``core/verify.py::sample_categorical``); the first token of
a request is drawn at temperature 1, as JAX's ``_first_token`` draws it.

Caches are updated in place and a step's ``state`` shares the cache
tensors of the state it was given; the serving engines run the step in
place as one captured CUDA graph (``serving/graph.py``), so nothing on
the step's path may wait on the device (no ``.item()``, no blocking host
copy).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.heads import (draft_tree_tokens, init_prefix_cache,
                                    prefix_forward)
from repro_torch.core.trees import device_arrays
from repro_torch.core.verify import (greedy_verify, sample_categorical,
                                     typical_verify)
from repro_torch.device import torch_dtype
from repro_torch.models.model import forward, init_cache
from repro_torch.serving.cache import ATTN_KEYS, commit_cache

PAD_TOKEN = -1
CRITERIA = ("greedy", "typical")


class DecodeState(NamedTuple):
    cache: Any                          # committed model cache
    cache_len: torch.Tensor             # (B,) int32
    last_token: torch.Tensor            # (B,) int64, not yet forwarded
    last_hidden: torch.Tensor           # (B, d) head-input hidden state
    prefix_k: Optional[torch.Tensor]    # PrefixAttention cache (hydra++)
    prefix_v: Optional[torch.Tensor]


class StepResult(NamedTuple):
    state: DecodeState
    emitted: torch.Tensor               # (B, D+1) tokens, PAD-filled
    n_emitted: torch.Tensor             # (B,) = n_accept + 1 (incl. bonus)


def _has_prefix(draft_params) -> bool:
    return draft_params is not None and "prefix" in draft_params


def check_criterion(criterion: str) -> None:
    if criterion not in CRITERIA:
        raise ValueError(f"criterion must be one of {CRITERIA}: {criterion}")


def _first_token(params, h_last, generator=None, greedy: bool = True,
                 gumbel=None):
    """First token of a freshly prefilled request from the hidden state of
    its last real prompt token: the argmax, or (``greedy=False``) a draw
    at temperature 1 from ``generator`` (or the given ``gumbel`` noise),
    as JAX's ``_first_token`` draws whatever the decode temperature."""
    logits = h_last.float() @ params["unembed_f32"]
    if greedy:
        return torch.argmax(logits, dim=-1)
    return sample_categorical(logits, generator, gumbel)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_decode_state(params, draft_params, cfg: ModelConfig, prompt,
                      max_len: int, generator=None, *,
                      greedy: bool = True) -> DecodeState:
    """prompt: (B, P) equal-length tokens.  Runs prefill, picks the first
    token (argmax, or a draw from ``generator`` unless ``greedy``),
    initializes all caches (on the prompt's device)."""
    B, P = prompt.shape
    dev = prompt.device
    pos = torch.arange(P, device=dev).expand(B, P)
    cache = init_cache(cfg, B, max_len, dev)
    # want_logits=False: only the last position's logits are needed
    out = forward(params, cfg, prompt, pos, mode="full", cache=cache,
                  want_logits=False)
    tok0 = _first_token(params, out.hidden[:, -1], generator, greedy)
    h = out.hidden[:, -1]
    pk = pv = None
    if _has_prefix(draft_params):
        ph, nk, nv = prefix_forward(draft_params, cfg, out.hidden, pos)
        pc = init_prefix_cache(cfg, B, max_len, dev)
        pk, pv = pc["k"], pc["v"]
        pk[:, :P] = nk.to(pk.dtype)
        pv[:, :P] = nv.to(pv.dtype)
        h = ph[:, -1]
    return DecodeState(cache=cache,
                       cache_len=torch.full((B,), P, dtype=torch.int32,
                                            device=dev),
                       last_token=tok0, last_hidden=h,
                       prefix_k=pk, prefix_v=pv)


def init_pool_state(params, draft_params, cfg: ModelConfig, max_batch: int,
                    max_len: int, device) -> DecodeState:
    """Empty slot-pool state for a continuous-batching engine: all caches
    zeroed, every row idle (cache_len 0).  Rows become live via
    ``join_slot`` and are stepped with an ``active`` mask."""
    pk = pv = None
    if _has_prefix(draft_params):
        pc = init_prefix_cache(cfg, max_batch, max_len, device)
        pk, pv = pc["k"], pc["v"]
    return DecodeState(
        cache=init_cache(cfg, max_batch, max_len, device),
        cache_len=torch.zeros((max_batch,), dtype=torch.int32, device=device),
        last_token=torch.zeros((max_batch,), dtype=torch.long, device=device),
        last_hidden=torch.zeros((max_batch, cfg.d_model),
                                dtype=torch_dtype(cfg.dtype), device=device),
        prefix_k=pk, prefix_v=pv)


@torch.no_grad()
def prefill_row(params, draft_params, cfg: ModelConfig, prompt,
                real_len: int, generator=None, greedy: bool = True):
    """Prefill one right-padded prompt (P,) into a fresh row cache of
    length P.  Returns (row cache, prefix (k, v) or None, first token,
    head-input hidden state).  With right padding and causal masking,
    positions < real_len never see the pad tail; the pads' entries sit at
    or beyond ``cache_len = real_len``, where every later step masks or
    overwrites them.  A recurrent group scans from a zero state (the row
    is fresh, so a re-prefill after a preemption starts over), length-
    masked at ``real_len``: the pads leave its state unchanged.  The first
    token is the argmax, or a draw from ``generator`` unless ``greedy``
    (a re-prefill draws afresh)."""
    P = prompt.shape[0]
    dev = prompt.device
    pos = torch.arange(P, device=dev)[None, :]
    row = init_cache(cfg, 1, P, dev)
    out = forward(params, cfg, prompt[None, :], pos, mode="full", cache=row,
                  valid_len=torch.full((1,), real_len, device=dev),
                  want_logits=False)
    idx = max(real_len - 1, 0)
    h = out.hidden[0, idx]
    tok0 = _first_token(params, h, generator, greedy)
    prefix = None
    if _has_prefix(draft_params):
        ph, nk, nv = prefix_forward(draft_params, cfg, out.hidden, pos)
        prefix = (nk[0], nv[0])
        h = ph[0, idx]
    return row, prefix, tok0, h


def join_slot(params, draft_params, cfg: ModelConfig, state: DecodeState,
              prompt, real_len: int, slot: int, generator=None, *,
              greedy: bool = True) -> DecodeState:
    """Prefill one request and install it in row ``slot`` of the pool (in
    place).  prompt: (P,) right-padded to P; ``real_len`` <= P is the true
    prompt length.  Only [0, P) of an attention row is written: positions
    past P are never read before a verify step overwrites them.  A
    recurrent state key is written whole (it has no sequence axis).  The
    first token as in ``prefill_row``."""
    P = prompt.shape[0]
    row, prefix, tok0, h = prefill_row(params, draft_params, cfg, prompt,
                                       real_len, generator, greedy)
    for pool, r in zip(state.cache, row):
        for key, arr in r.items():
            if key in ATTN_KEYS:
                pool[key][:, slot, :P] = arr[:, 0]
            else:
                pool[key][:, slot] = arr[:, 0]
    if prefix is not None:
        state.prefix_k[slot, :P] = prefix[0]
        state.prefix_v[slot, :P] = prefix[1]
    state.cache_len[slot] = real_len
    state.last_token[slot] = tok0
    state.last_hidden[slot] = h.to(state.last_hidden.dtype)
    return state


# ---------------------------------------------------------------------------
# chunked (resumable) prefill: DESIGN.md §8
# ---------------------------------------------------------------------------


def carried_state(arr, slot: int, start: int):
    """Row ``slot`` of a recurrent-state array (L, B, ...) as an in-place
    view (L, 1, ...), zeroed when the chunk is a prefill's first
    (``start == 0``): the row still holds the slot's previous occupant's
    state.  Stale attention entries need no reset: the chunk form masks
    every key at or past the prefill cursor."""
    row = arr[:, slot:slot + 1]
    if start == 0:
        row.zero_()
    return row


def chunk_operands(chunk, start: int, real_len: int):
    """(positions (1, C), start (1,) int32, valid_len (1,)) of one chunk:
    its tokens sit at ``start + arange(C)`` and the first ``real_len -
    start`` of them (at most C) are real."""
    C, dev = chunk.shape[0], chunk.device
    pos = torch.arange(start, start + C, device=dev)[None, :]
    start1 = torch.full((1,), start, dtype=torch.int32, device=dev)
    valid = torch.full((1,), min(max(real_len - start, 0), C),
                       dtype=torch.int32, device=dev)
    return pos, start1, valid


def install_chunk(params, state, hidden, prefix_hidden, start: int,
                  real_len: int, slot: int, final: bool, generator=None,
                  greedy: bool = True):
    """Advance row ``slot`` of ``state`` (a ``DecodeState`` or a paged
    state: any with ``cache_len``/``last_token``/``last_hidden``) after
    one chunk, in place.  A non-final chunk moves the prefill cursor
    (``cache_len = start + C``: the slot stays inactive, and the scratch
    a concurrent decode step writes past the cursor is overwritten by
    the next chunk); the final chunk picks the first token from the
    hidden state of token ``real_len - 1`` and installs ``last_token``,
    ``last_hidden`` and ``cache_len = real_len`` (the first token as in
    ``prefill_row``)."""
    C = hidden.shape[1]
    if not final:
        state.cache_len[slot] = start + C
        return state
    idx = min(max(real_len - start - 1, 0), C - 1)
    state.cache_len[slot] = real_len
    state.last_token[slot] = _first_token(params, hidden[0, idx], generator,
                                          greedy)
    h = (prefix_hidden if prefix_hidden is not None else hidden)[0, idx]
    state.last_hidden[slot] = h.to(state.last_hidden.dtype)
    return state


@torch.no_grad()
def join_slot_chunk(params, draft_params, cfg: ModelConfig,
                    state: DecodeState, chunk, start: int, real_len: int,
                    slot: int, *, final: bool,
                    view_len: Optional[int] = None, generator=None,
                    greedy: bool = True) -> DecodeState:
    """One chunk of a resumable prefill into row ``slot`` of the pool, in
    place.

    ``chunk``: (C,) tokens ``[start, start + C)`` of the request's
    C-padded context; ``real_len`` is the true context length (only the
    final chunk may carry right-pad).  The chunk runs a prefill
    continuation (``forward(mode="full", cache_len=start)``): attention
    writes the chunk K/V at ``[start, start + C)`` of the slot's row and
    attends through K3's chunk form, recurrent state scans on from the
    row's carried state (zeroed for the first chunk), so chunking is pure
    scheduling.  The forward writes straight into views of the slot's
    row, so there is nothing to commit afterwards (JAX's ``commit_chunk``
    copies the chunk back from a row copy) and no position of the row
    outside ``[start, start + C)`` changes.  ``view_len`` cuts the
    attention view to the row's first ``view_len`` positions (it must
    cover ``start + C``); the masked tail never changes a bit.

    A non-final chunk moves the prefill cursor; the final one
    (``final=True``) picks the first token (a draw from ``generator``
    unless ``greedy``) and activates the row (``install_chunk``)."""
    pos, start1, valid = chunk_operands(chunk, start, real_len)
    view = slice(None, view_len)
    rows = [{key: (a[:, slot:slot + 1, view] if key in ATTN_KEYS
                   else carried_state(a, slot, start))
             for key, a in g.items()} for g in state.cache]
    out = forward(params, cfg, chunk[None, :], pos, mode="full", cache=rows,
                  cache_len=start1, valid_len=valid, want_logits=False)
    ph = None
    if _has_prefix(draft_params):
        ph, _, _ = prefix_forward(
            draft_params, cfg, out.hidden, pos,
            cache_k=state.prefix_k[slot:slot + 1, view],
            cache_v=state.prefix_v[slot:slot + 1, view], cache_len=start1,
            prefill=True)
    return install_chunk(params, state, out.hidden, ph, start, real_len, slot,
                         final, generator, greedy)


# ---------------------------------------------------------------------------
# the speculative step
# ---------------------------------------------------------------------------


def _freeze_inactive(active, state: DecodeState, emitted, n_emitted,
                     cache_len, last_token, last_hidden):
    """Rows outside ``active`` emit PAD, advance no cache and keep their
    token/hidden state; their attention writes stayed in their scratch
    region beyond the frozen ``cache_len``."""
    emitted = torch.where(active[:, None], emitted, PAD_TOKEN)
    n_emitted = torch.where(active, n_emitted, 0)
    cache_len = torch.where(active, cache_len, state.cache_len)
    last_token = torch.where(active, last_token, state.last_token)
    last_hidden = torch.where(active[:, None], last_hidden, state.last_hidden)
    return emitted, n_emitted, cache_len, last_token, last_hidden


@torch.no_grad()
def spec_decode_step(params, draft_params, cfg: ModelConfig, tree,
                     state: DecodeState, *, criterion: str = "greedy",
                     temperature: float = 0.7, epsilon: float = 0.15,
                     alpha: Optional[float] = None, generator=None,
                     active: Optional[torch.Tensor] = None,
                     block_table: Optional[torch.Tensor] = None
                     ) -> StepResult:
    """``criterion``: ``"greedy"`` (draws nothing) or ``"typical"``
    (typical acceptance at ``temperature``/``epsilon``/``alpha``, its
    bonus token drawn from ``generator``); anything else raises.
    ``active`` (B,) bool: rows that hold a live request (None: all).
    ``block_table`` (B, M) int32 switches the cache layout: ``state.cache``
    attention arrays (and the Hydra++ prefix cache) are then global block
    pools streamed through the table by the paged kernel, and the commit
    moves accepted entries inside slot-owned blocks."""
    B = state.last_token.shape[0]
    dev = state.last_token.device
    ta = device_arrays(tree, dev)

    # 1. draft: populate the candidate tree (root = last_token)
    tokens, _ = draft_tree_tokens(draft_params, cfg, params, tree,
                                  state.last_hidden, state.last_token)

    # 2. verify: one base forward over the T tree tokens
    positions = state.cache_len[:, None] + ta["depth"][None, :]
    out = forward(params, cfg, tokens, positions, mode="verify",
                  cache=state.cache, cache_len=state.cache_len,
                  tree_mask=ta["mask"], block_table=block_table)

    # 3. accept
    if criterion == "greedy":
        res = greedy_verify(tree, tokens, out.logits)
    elif criterion == "typical":
        res = typical_verify(tree, tokens, out.logits, generator,
                             temperature=temperature, epsilon=epsilon,
                             alpha=alpha)
    else:
        raise ValueError(f"criterion must be one of {CRITERIA}: {criterion}")

    # 4. commit (a recurrent group's inactive rows keep their state)
    cache = commit_cache(out.cache, state.cache_len, res.path_nodes,
                         res.n_accept, active=active, prev=state.cache,
                         block_table=block_table)
    D1 = res.path_nodes.shape[1]
    bidx = torch.arange(B, device=dev)
    acc_hidden = out.hidden[bidx[:, None], res.path_nodes]     # (B, D1, d)

    pk, pv = state.prefix_k, state.prefix_v
    if _has_prefix(draft_params):
        ppos = state.cache_len[:, None] + torch.arange(D1, device=dev)[None]
        ph, pk, pv = prefix_forward(
            draft_params, cfg, acc_hidden, ppos, cache_k=pk, cache_v=pv,
            cache_len=state.cache_len, tree_mask=None,         # chain mask
            block_table=block_table)
        # the chain write already left path step j at scratch entry j, so
        # the prefix cache is committed (JAX's commit is the identity gather)
        h_next = ph[bidx, res.n_accept]
    else:
        h_next = acc_hidden[bidx, res.n_accept]

    # 5. emitted tokens: accepted candidates then the bonus token
    tok_path = tokens[bidx[:, None], res.path_nodes]           # (B, D1)
    j = torch.arange(D1, device=dev)[None, :]
    pad = torch.full((B, 1), PAD_TOKEN, dtype=tok_path.dtype, device=dev)
    shifted = torch.cat([tok_path[:, 1:], pad], dim=1)
    emitted = torch.where(j < res.n_accept[:, None], shifted, PAD_TOKEN)
    emitted = torch.where(j == res.n_accept[:, None],
                          res.bonus_token[:, None], emitted)

    n_emitted = res.n_accept + 1
    cache_len = (state.cache_len + n_emitted).to(torch.int32)
    last_token, last_hidden = res.bonus_token, h_next
    if active is not None:
        emitted, n_emitted, cache_len, last_token, last_hidden = \
            _freeze_inactive(active, state, emitted, n_emitted, cache_len,
                             last_token, last_hidden)
    new_state = DecodeState(cache=cache, cache_len=cache_len,
                            last_token=last_token, last_hidden=last_hidden,
                            prefix_k=pk, prefix_v=pv)
    return StepResult(new_state, emitted, n_emitted)


# ---------------------------------------------------------------------------
# autoregressive baseline step (T=1 "tree")
# ---------------------------------------------------------------------------


@torch.no_grad()
def autoregressive_step(params, cfg: ModelConfig, state: DecodeState, *,
                        greedy: bool = True, temperature: float = 1.0,
                        generator=None, active: Optional[torch.Tensor] = None,
                        block_table: Optional[torch.Tensor] = None,
                        gumbel: Optional[torch.Tensor] = None) -> StepResult:
    """One token per row: a verify of the one-node tree, then the argmax,
    or (``greedy=False``) a draw at ``temperature`` from ``generator``
    (``gumbel`` (B, V) replaces the draw).  The new
    attention entry was written at ``cache_len``, where it stays (the
    commit leaves attention groups alone for a one-node path); a
    recurrent group commits its one candidate."""
    B = state.last_token.shape[0]
    dev = state.last_token.device
    tokens = state.last_token[:, None]
    positions = state.cache_len[:, None]
    out = forward(params, cfg, tokens, positions, mode="verify",
                  cache=state.cache, cache_len=state.cache_len,
                  tree_mask=None, block_table=block_table)
    zero = torch.zeros((B,), dtype=torch.long, device=dev)
    cache = commit_cache(out.cache, state.cache_len, zero[:, None], zero,
                         active=active, prev=state.cache,
                         block_table=block_table)
    logits = out.logits[:, 0]
    nxt = (torch.argmax(logits, dim=-1) if greedy else
           sample_categorical(logits / temperature, generator, gumbel))
    emitted = nxt[:, None]
    n_emitted = torch.ones_like(nxt)
    cache_len = (state.cache_len + 1).to(torch.int32)
    last_hidden = out.hidden[:, 0]
    if active is not None:
        emitted, n_emitted, cache_len, nxt, last_hidden = _freeze_inactive(
            active, state, emitted, n_emitted, cache_len, nxt, last_hidden)
    new_state = DecodeState(cache=cache, cache_len=cache_len,
                            last_token=nxt, last_hidden=last_hidden,
                            prefix_k=state.prefix_k, prefix_v=state.prefix_v)
    return StepResult(new_state, emitted, n_emitted)


# ---------------------------------------------------------------------------
# generation loop
# ---------------------------------------------------------------------------


def generate(params, draft_params, cfg: ModelConfig, tree, prompt, *,
             max_new_tokens: int = 64, max_len: int = 1024,
             use_speculative: bool = True, criterion: str = "greedy",
             temperature: float = 0.7, epsilon: float = 0.15,
             generator: Optional[torch.Generator] = None):
    """Generation for a (B, P) prompt on its device.  ``criterion``
    ``"greedy"`` decodes greedily; ``"typical"`` samples the first token
    (temperature 1) and then accepts typically (speculative) or samples
    each token at ``temperature`` (``use_speculative=False``), drawing
    from ``generator`` (default: one on the prompt's device seeded 0, as
    JAX's default key is ``PRNGKey(0)``).  Returns (tokens (B, N) with
    PAD tails inside step segments, steps_taken, accept_lengths (B,
    steps) fp32)."""
    check_criterion(criterion)
    greedy = criterion == "greedy"
    if generator is None and not greedy:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    state = init_decode_state(params, draft_params, cfg, prompt, max_len,
                              generator, greedy=greedy)
    B = prompt.shape[0]
    outs = [state.last_token[:, None]]  # first token from prefill
    produced = 1
    steps = 0
    accept_lens = []
    while produced < max_new_tokens:
        if use_speculative:
            res = spec_decode_step(params, draft_params, cfg, tree, state,
                                   criterion=criterion,
                                   temperature=temperature, epsilon=epsilon,
                                   generator=generator)
        else:
            res = autoregressive_step(params, cfg, state, greedy=greedy,
                                      temperature=temperature,
                                      generator=generator)
        state = res.state
        outs.append(res.emitted)
        accept_lens.append(res.n_emitted)
        produced += int(res.n_emitted.min())
        steps += 1
        if steps > 4 * max_new_tokens:
            break
    toks = torch.cat(outs, dim=1)
    acc = (torch.stack(accept_lens, 1).float() if accept_lens
           else torch.ones((B, 1)))
    return toks, steps, acc
