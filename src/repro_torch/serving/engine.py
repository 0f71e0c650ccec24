"""Speculative serving engines (port of ``repro/serving/engine.py``).

``SpeculativeEngine`` — continuous batching over a dense cache.  A fixed
pool of ``max_batch`` slots and a FIFO request queue.  A request joins the
pool the moment a slot is free (per-slot prefill via ``join_slot``; prompt
lengths are right-padded to a bucket), decodes with its own per-slot
``cache_len``/budget/EOS, and its slot is freed and refilled the moment
it finishes.  Idle rows ride along in the step with ``active=False``: they
emit PAD, advance no cache and keep their state.

``PagedSpeculativeEngine`` — the same scheduler over a paged KV cache
(``serving/paged.py``).  The pool may be smaller than
``max_batch × max_len``; per-slot block tables grow on demand.  Exhaustion
is never a crash: a request that does not fit waits in the queue
(admission control), and when an active slot cannot grow, the most
recently joined slot is preempted: its blocks are freed and its request
requeued at the front, to be re-prefilled later from prompt + tokens so
far (byte-exact under greedy decoding).

The serve loop is **asynchronous** by default (DESIGN.md §7): with
``inflight=2`` step k+1 is dispatched before step k's emissions are read
back, so harvest, joins and the allocator run on the host while the card
computes.  Every read (a step's emissions, the first token a join
installs) runs one step behind the dispatch; ``inflight=1`` is the same
loop degenerated to the synchronous one.  The overlap reorders host
bookkeeping only, never device work, so greedy outputs are the same for
every ``inflight``.  Requests arrive through a live queue: ``submit()``
enqueues at any time, ``drain()`` serves what was submitted, and
``serve(source=...)`` pulls from an iterable or callable on a feeder
thread through a bounded handoff queue.

On CUDA the decode step runs as one captured CUDA graph
(``serving/graph.py::CapturedStep``), taken at ``serve``'s warm-up and
replayed every step: the port's counterpart of the JAX engine's one
compiled step per ``(max_batch, tree)``.  ``capture_step=False`` runs
the step eagerly; on the CPU it always runs eagerly.  Joins and chunks
run eagerly.

Chunked prefill (``prefill_chunk > 0``, DESIGN.md §8): a request joins a
slot in the *prefilling* state and its context, right-padded to a chunk
multiple, is prefilled one chunk at a time (``join_slot_chunk``, paged
``paged_join_slot_chunk``), at most ``prefill_budget`` prompt tokens per
loop iteration beside the decode step of the active slots; the final
chunk activates the slot and registers its first token like a join.  The
paged engine allocates blocks one chunk at a time and may preempt a slot
mid-prefill (it restarts from chunk 0).

``BucketedEngine`` — the static baseline: requests grouped by exact
prompt length, each batch prefilled at once and stepped to completion.

Sampling (``criterion="typical"``, JAX's defaults ``temperature=0.7``,
``epsilon=0.15``): every engine holds one ``torch.Generator`` on its
device, seeded from ``seed``, in place of the JAX engine's key that is
split per serve, per join and per step.  Joins, chunks and steps draw
from it in the order the host issues them, so the same seed and the same
schedule give the same streams; a preempted request re-prefills and
draws afresh.  Warm-up steps and the capture leave the generator as they
found it.  Greedy decoding draws nothing.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.speculative import (autoregressive_step,
                                          check_criterion, init_decode_state,
                                          init_pool_state, join_slot,
                                          join_slot_chunk, spec_decode_step)
from repro_torch.device import resolve_device
from repro_torch.models.model import attention_group, group_program
from repro_torch.serving.graph import (CapturedStep, HostRead, snapshot,
                                       step_in_place)
from repro_torch.serving.paged import (NULL_BLOCK, BlockAllocator,
                                       init_paged_state,
                                       paged_autoregressive_step,
                                       paged_join_slot, paged_join_slot_chunk,
                                       paged_spec_decode_step)

# feeder-thread end-of-stream marker (see SpeculativeEngine._feed_source)
_SOURCE_DONE = object()
# the longest a feeder put or a feeder join waits before it looks again
_FEED_TIMEOUT_S = 0.05
_FEEDER_JOIN_S = 2.0


@dataclass
class Request:
    """One generation request.

    ``prompt`` is the token context; the engine appends every generated
    token (including the one picked at prefill) to ``output`` and sets
    ``done`` when the budget is exhausted or ``eos_token`` is produced.
    ``output`` survives preemption: a preempted request resumes by
    re-prefilling ``prompt + output``.
    """

    prompt: np.ndarray
    max_new_tokens: int = 64
    eos_token: Optional[int] = None
    output: List[int] = field(default_factory=list)
    done: bool = False
    # serving timeline (wall-clock seconds, filled in by the engine)
    t_enqueue: Optional[float] = None
    t_join: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_emit: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_enqueue is None:
            return None
        return self.t_done - self.t_enqueue

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_enqueue is None:
            return None
        return self.t_first_token - self.t_enqueue


@dataclass
class EngineStats:
    """Accumulated serving counters (one instance per engine, across every
    ``serve`` call).

    steps            decode steps executed and read (prefills and warm-up
                     excluded)
    warmup_steps     steps run before the clock starts (all rows idle)
    tokens           tokens delivered to requests post-prefill (clamped at
                     each request's budget)
    wall_s           wall-clock seconds inside the serving loop
    host_stall_s     seconds the host worked while NO step was in flight:
                     from a harvest that drained the window to the next
                     dispatch (join, chunk or step).  The synchronous loop
                     (``inflight=1``) pays it at every step; the async one
                     only where the window drains (tails, preemptions).
                     The eager dispatch of a step's operators counts as
                     device work queued, not as a stall
    read_wait_s      seconds blocked in device-to-host reads (step
                     emissions, first tokens)
    steps_in_flight  high-water mark of dispatched-but-unharvested steps
                     (1: the synchronous loop, 2: double-buffered)
    captures         CUDA graphs of the step taken (one per pool shape;
                     the replays are ``captured.replays``)
    step_s           per step: dispatch to emissions read, seconds (under
                     ``inflight=2`` it spans the next step's dispatch too)
    accept_lengths   per-step mean accepted+bonus length over live rows
    active_slot_steps / capacity_slot_steps
                     slot occupancy: live rows vs ``max_batch`` per step
    request_latency_s, ttft_s, itl_s
                     per request queue-to-finish and queue-to-first-token,
                     and per token the inter-token gap (a read delivering
                     n tokens after a gap g adds n samples of g/n)
    prefill_chunks   chunked prefill: chunks dispatched (re-prefills after
                     a preemption included)
    prefill_tokens   chunked prefill: real (non-pad) prompt tokens in them

    Paged-cache accounting (zero for the dense engine): ``block_size``,
    ``num_blocks`` (incl. the NULL block), ``pool_tokens`` (usable
    positions), ``dense_equiv_tokens`` (``max_batch × max_len``),
    ``peak_blocks_in_use``, ``preemptions`` and ``step_transient_tokens``
    (positions a step writes beyond the persistent pool: the
    ``max_batch × T`` scratch of the native kernel path).
    """

    steps: int = 0
    warmup_steps: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    host_stall_s: float = 0.0
    read_wait_s: float = 0.0
    steps_in_flight: int = 0
    captures: int = 0
    step_s: List[float] = field(default_factory=list)
    accept_lengths: List[float] = field(default_factory=list)
    active_slot_steps: int = 0
    capacity_slot_steps: int = 0
    request_latency_s: List[float] = field(default_factory=list)
    ttft_s: List[float] = field(default_factory=list)
    itl_s: List[float] = field(default_factory=list)
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    block_size: int = 0
    num_blocks: int = 0
    pool_tokens: int = 0
    dense_equiv_tokens: int = 0
    peak_blocks_in_use: int = 0
    preemptions: int = 0
    step_transient_tokens: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens / max(self.steps, 1)

    @property
    def host_stall_frac(self) -> float:
        return self.host_stall_s / max(self.wall_s, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.wall_s, 1e-9)

    @property
    def slot_utilization(self) -> float:
        return self.active_slot_steps / max(self.capacity_slot_steps, 1)

    @staticmethod
    def _mean(xs) -> float:
        return float(np.mean(xs)) if xs else 0.0

    @staticmethod
    def _p99(xs) -> float:
        return float(np.percentile(xs, 99)) if xs else 0.0

    @property
    def mean_latency_s(self) -> float:
        return self._mean(self.request_latency_s)

    @property
    def p99_latency_s(self) -> float:
        return self._p99(self.request_latency_s)

    @property
    def mean_ttft_s(self) -> float:
        return self._mean(self.ttft_s)

    @property
    def p99_ttft_s(self) -> float:
        return self._p99(self.ttft_s)

    @property
    def mean_itl_s(self) -> float:
        return self._mean(self.itl_s)

    @property
    def p99_itl_s(self) -> float:
        return self._p99(self.itl_s)

    @property
    def mean_step_s(self) -> float:
        return self._mean(self.step_s)

    @property
    def peak_pool_tokens(self) -> int:
        return self.peak_blocks_in_use * self.block_size

    @property
    def kv_pool_frac(self) -> float:
        """Pool reservation as a fraction of the dense-equivalent one."""
        if not self.dense_equiv_tokens:
            return 1.0
        return self.pool_tokens / self.dense_equiv_tokens


@dataclass
class _PrefillJob:
    """Host-side progress of one chunked prefill (slot state
    'prefilling', DESIGN.md §8).  ``ctx`` is the request's context
    (prompt + any resumed output) right-padded to a chunk multiple;
    ``off`` is the prefill cursor, the tokens already dispatched.  Its
    device mirror is ``cache_len[slot]``, which each chunk advances, so a
    decode step running beside the prefill writes its masked scratch for
    this row AHEAD of the cursor, where the next chunk overwrites it."""

    request: Request
    ctx: np.ndarray
    real_len: int
    off: int = 0


class _StepRecord(NamedTuple):
    """One dispatched-but-unharvested decode step (DESIGN.md §7).

    Everything the harvest needs is taken at dispatch: the ``active``
    mask and slot -> request assignment the step ran with (host state
    moves on while it is in flight), the joins dispatched just before it,
    each with a host copy of the first token it installed (read one step
    later; a later replay or join overwrites the device row), and the
    step's emissions, already on their way to the host."""

    out: HostRead                   # (emitted (B, D+1), n_emitted (B,))
    active: np.ndarray              # (B,) bool mask the step ran with
    slots: List[Optional[Request]]  # slot -> request at dispatch
    joins: List[tuple]              # [(slot, Request, HostRead of token)]
    max_batch: int
    t_dispatch: float


# A live request source for ``serve``: an iterable (pulled lazily as slots
# free up; exhaustion ends the stream) or a zero-argument callable polled
# by the feeder thread (returns newly arrived requests, an empty iterable
# for "nothing yet, keep serving", or None for "no more ever").
RequestSource = Union[Iterable[Request], Callable[[], Any]]


class SpeculativeEngine:
    """Continuous-batching speculative engine over a dense cache.

    ``submit(request)`` enqueues (FIFO) at any time: before, between or
    during ``serve`` calls.  ``serve(requests=(), *, source=None,
    max_batch=8, warmup=True) -> EngineStats`` runs the loop until the
    queue, the optional live ``source`` (see ``RequestSource``) and every
    step in flight drain; ``drain()`` is ``serve`` over what was
    submitted; ``stats`` accumulates across calls.  Per request:
    **enqueue** -> **join** the moment a slot frees (bucketed prefill; its
    first token is read back one step later) -> **harvest** one step
    behind dispatch (accepted + bonus tokens appended to
    ``Request.output``, clamped at ``max_new_tokens``, cut at
    ``eos_token``) -> **finish** (slot freed and refilled from the queue).
    ``warmup`` runs one step over the idle pool before the clock starts.

    ``inflight`` (default 2) bounds the dispatched-but-unharvested steps
    (DESIGN.md §7); host state is then up to ``inflight - 1`` steps stale
    at dispatch, every capacity decision budgets for it
    (``_stale_allowance``), and a request found finished at harvest may
    ride one dispatched step as a masked "zombie" row whose emissions are
    dropped.  ``inflight=1`` is the synchronous loop.

    ``capture_step`` (default True) runs the step as one CUDA graph on a
    CUDA engine (``serving/graph.py``), captured at the first ``serve``'s
    warm-up and reused across ``serve`` calls, occupancy changes and live
    submits; a new ``max_batch`` takes a new capture (and a new pool).
    False runs the step eagerly; the CPU always does.

    ``criterion`` (``"greedy"`` or ``"typical"``), ``temperature`` and
    ``epsilon`` pick the acceptance rule (and, with
    ``use_speculative=False``, sampled tokens at ``temperature``); the
    draws come from ``self.generator``, seeded from ``seed``.

    ``prefill_chunk`` (0: whole-prompt joins) prefills in chunks of that
    many tokens, rounded up to the recurrent scan's chunk for RWKV6 and
    Mamba2, so a chunk boundary is a scan-chunk boundary; ``prefill_budget``
    (default one chunk, at least one chunk) caps the prompt tokens
    dispatched per loop iteration.

    Subclass hooks (``_init_pool`` / ``_admit`` / ``_admit_prefill`` /
    ``_grow_prefill`` / ``_advance_prefill_cursor`` / ``_before_step`` /
    ``_advance`` / ``_release`` / ``_post_serve``) are trivial here; the
    paged engine overrides them for block accounting.
    """

    def __init__(self, params, draft_params, cfg: ModelConfig, tree, *,
                 max_len: int = 2048, use_speculative: bool = True,
                 prefill_bucket: int = 32, prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None, inflight: int = 2,
                 capture_step: bool = True, criterion: str = "greedy",
                 temperature: float = 0.7, epsilon: float = 0.15,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode "
                             "service")
        check_criterion(criterion)
        self.params = params
        self.draft_params = draft_params
        self.cfg = cfg
        self.tree = tree
        self.max_len = max_len
        self.use_speculative = use_speculative
        self.criterion = criterion
        self.greedy = criterion == "greedy"
        self.temperature = float(temperature)
        self.epsilon = float(epsilon)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.prefill_bucket = max(int(prefill_bucket), 1)
        prefill_chunk = int(prefill_chunk or 0)
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0: {prefill_chunk}")
        if prefill_chunk and cfg.block_kind in ("mamba2", "rwkv6"):
            inner = cfg.ssm.chunk_size
            prefill_chunk = -(-prefill_chunk // inner) * inner
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = 0
        if prefill_chunk:
            self.prefill_budget = int(prefill_budget or prefill_chunk)
            if self.prefill_budget < prefill_chunk:
                raise ValueError(
                    f"prefill_budget {self.prefill_budget} < prefill_chunk "
                    f"{prefill_chunk}: the scheduler could never dispatch "
                    "a chunk")
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1: {inflight}")
        self.inflight = int(inflight)
        # a graph needs the card; the CPU runs the same step eagerly
        self.capture_step = bool(capture_step) and self.device.type == "cuda"
        # does a chunk's attention view grow with the prefill cursor?  A
        # recurrent stack without a Hydra++ prefix cache has none
        self._view_grows = (
            any(attention_group(kind) for kind, _ in group_program(cfg))
            or (draft_params is not None and "prefix" in draft_params))
        self.stats = EngineStats()
        self.captured: Optional[CapturedStep] = None
        self._pool = None                    # (max_batch, device state)
        self._queue: deque = deque()
        self._inflight: deque = deque()
        self._live_joins: dict = {}          # slot -> (Request, HostRead)
        self._prefills: dict = {}            # slot -> _PrefillJob
        self._src_thread: Optional[threading.Thread] = None
        self._starve_t0: Optional[float] = None

    # -- the step and the join (the paged engine swaps the layout) -----------

    def _sampling(self) -> dict:
        """The step's sampling arguments (nothing is drawn under greedy)."""
        if self.use_speculative:
            return dict(criterion=self.criterion,
                        temperature=self.temperature, epsilon=self.epsilon,
                        generator=self.generator)
        return dict(greedy=self.greedy, temperature=self.temperature,
                    generator=self.generator)

    def _step(self, state, active, table=None):
        """The eager step over ``state`` (returns a ``StepResult``)."""
        if self.use_speculative:
            return spec_decode_step(self.params, self.draft_params, self.cfg,
                                    self.tree, state, active=active,
                                    **self._sampling())
        return autoregressive_step(self.params, self.cfg, state,
                                   active=active, **self._sampling())

    def _table(self) -> Optional[np.ndarray]:
        """The host block table a step runs with (None: dense layout)."""
        return None

    def _run_step(self, state, active: np.ndarray):
        """Dispatch one step over ``state`` in place (a replay of the
        captured graph, or the eager step); returns its ``(emitted,
        n_emitted)`` device tensors, which a replay overwrites: copy them
        out before the next dispatch."""
        table = self._table()
        if self.captured is not None:
            return self.captured(active, table)
        return step_in_place(
            self._step, state, snapshot(active, self.device),
            None if table is None else snapshot(table, self.device))

    def _join(self, state, slot: int, r: Request):
        padded, n = self._padded_context(r)
        return join_slot(self.params, self.draft_params, self.cfg, state,
                         snapshot(padded, self.device), n, slot,
                         self.generator, greedy=self.greedy)

    def _dispatch_chunk(self, state, si: int, chunk: np.ndarray, start: int,
                        real_len: int, final: bool):
        view = self._chunk_view_len(start + self.prefill_chunk)
        return join_slot_chunk(self.params, self.draft_params, self.cfg,
                               state, snapshot(chunk, self.device),
                               start, real_len, si, final=final,
                               view_len=view, generator=self.generator,
                               greedy=self.greedy)

    # -- prefill-on-join -----------------------------------------------------

    def _pad_len(self, n: int) -> int:
        # chunked prefill pads the context to a chunk multiple instead of
        # a bucket multiple (every chunk is exactly prefill_chunk wide)
        b = self.prefill_chunk or self.prefill_bucket
        return max(-(-n // b) * b, b)

    @property
    def _scratch(self) -> int:
        """Cache positions one verify step writes past ``cache_len``."""
        return self.tree.size if self.use_speculative else 1

    @property
    def _max_emit(self) -> int:
        """Most tokens one step can commit to a row (accepted + bonus)."""
        return self.tree.max_depth + 1 if self.use_speculative else 1

    @property
    def _stale_allowance(self) -> int:
        """Cache positions a row can advance past the host's knowledge:
        up to ``inflight - 1`` unharvested steps, each committing at most
        ``_max_emit`` tokens.  Every capacity decision (admission,
        growth, the up-front reject) budgets it; 0 for the synchronous
        loop."""
        return (self.inflight - 1) * self._max_emit

    def _context(self, r: Request) -> np.ndarray:
        """Prefill context: the prompt, plus tokens already generated when
        the request is resuming after a preemption."""
        ctx = np.asarray(r.prompt, np.int64)
        if r.output:
            ctx = np.concatenate([ctx, np.asarray(r.output, np.int64)])
        return ctx

    def _padded_context(self, r: Request):
        """(bucket-padded context array, real length) for a join/rejoin."""
        ctx = self._context(r)
        n = len(ctx)
        padded = np.zeros(self._pad_len(n), np.int64)
        padded[:n] = ctx
        return padded, n

    def _check_capacity(self, r: Request) -> None:
        # the stale allowance covers the zombie step a finished request
        # may ride before the harvest finds it finished
        need = (self._pad_len(len(r.prompt)) + r.max_new_tokens
                + self._scratch + self._stale_allowance)
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache slots (padded prompt "
                f"{self._pad_len(len(r.prompt))} + budget {r.max_new_tokens} "
                f"+ {self._scratch} verify scratch + {self._stale_allowance} "
                f"async staleness) but max_len={self.max_len}")

    # -- chunked prefill (DESIGN.md §8) --------------------------------------

    def _chunk_view_len(self, end: int) -> int:
        """Attention-view extent for a chunk whose writes end at ``end``:
        the next power of two >= max(end, 64), at most the row's capacity.
        The masked tail never changes a bit; the extent bounds how much of
        the cache a chunk gathers and sweeps."""
        cap = self.max_len
        if not self._view_grows:
            return cap
        v = 64
        while v < min(end, cap):
            v *= 2
        return min(v, cap)

    def _start_prefill(self, si: int, r: Request, slots) -> None:
        """Move a queue head into slot ``si`` in the 'prefilling' state:
        the slot is owned (joins skip it) but inactive (decode steps mask
        it) until its final chunk lands."""
        padded, n = self._padded_context(r)
        self._prefills[si] = _PrefillJob(request=r, ctx=padded, real_len=n)
        slots[si] = r
        r.t_join = time.time()
        self._seq += 1
        self._join_seq[si] = self._seq

    def _pump_prefill(self, si: int, state, active, slots, pending,
                      joins: list, budget: int):
        """Dispatch as many of slot ``si``'s remaining chunks as ``budget``
        allows.  The final chunk activates the slot and registers the
        deferred read of its first token exactly as a whole-prompt join
        does."""
        C = self.prefill_chunk
        while si in self._prefills and budget >= C:
            job = self._prefills[si]
            if not self._grow_prefill(si, job, slots, active, pending):
                break                      # _grow_prefill preempted si
            start, end = job.off, job.off + C
            final = end >= len(job.ctx)
            self._device_fed()
            state = self._dispatch_chunk(state, si, job.ctx[start:end],
                                         start, job.real_len, final)
            job.off = end
            budget -= C
            self.stats.prefill_chunks += 1
            self.stats.prefill_tokens += max(min(end, job.real_len) - start,
                                             0)
            self._advance_prefill_cursor(si, min(end, job.real_len))
            if final:
                del self._prefills[si]
                self._register_join(si, job.request, state, active, joins)
        return state, budget

    def _advance_prefills(self, state, slots, active, pending, joins: list):
        """The chunked-prefill lane of one loop iteration: advance the
        prefills in progress oldest first, then admit queue heads into
        free slots, dispatching at most ``prefill_budget`` prompt tokens
        in all.  Returns (state, whether a chunk was dispatched): the
        loop's deadlock check counts a dispatched chunk as progress."""
        budget = self.prefill_budget
        dispatched = self.stats.prefill_chunks
        for si in sorted(self._prefills, key=lambda s: self._join_seq[s]):
            state, budget = self._pump_prefill(si, state, active, slots,
                                               pending, joins, budget)
        for si in range(len(slots)):
            if budget < self.prefill_chunk or not pending:
                break
            if active[si] or si in self._prefills:
                continue
            if not self._admit_prefill(pending[0]):
                break                      # strict FIFO: head blocks tail
            self._start_prefill(si, pending.popleft(), slots)
            state, budget = self._pump_prefill(si, state, active, slots,
                                               pending, joins, budget)
        return state, self.stats.prefill_chunks != dispatched

    # -- scheduler hooks (the paged engine overrides them) --------------------

    def _admit_prefill(self, r: Request) -> bool:
        """Admission for a chunked join (paged: priced on its first
        chunk)."""
        return self._admit(r)

    def _grow_prefill(self, si: int, job: _PrefillJob, slots, active,
                      pending) -> bool:
        """Capacity for the next chunk's writes (paged: allocate its
        blocks, preempting on exhaustion; False when ``si`` itself was
        preempted).  A dense row always has it."""
        return True

    def _advance_prefill_cursor(self, si: int, n: int) -> None:
        """Host mirror of the prefill cursor (paged: ``_slot_len``)."""

    def _init_pool(self, max_batch: int):
        self.stats.dense_equiv_tokens = max_batch * self.max_len
        return self._device_pool(max_batch, lambda: init_pool_state(
            self.params, self.draft_params, self.cfg, max_batch, self.max_len,
            self.device))

    def _device_pool(self, max_batch: int, make):
        """The device pool state for ``max_batch`` slots: the one kept from
        the last ``serve`` zeroed in place (the captured step reads and
        writes its tensors), or a new one from ``make()``, captured anew
        when ``capture_step``."""
        if self._pool is not None and self._pool[0] == max_batch:
            state = self._pool[1]
            for t in _tensors(state):
                t.zero_()
            return state
        self.captured = self._pool = None     # free the old capture first
        state = make()
        self._pool = (max_batch, state)
        if self.capture_step:
            table = self._table()
            self.captured = CapturedStep(
                self._step, state, max_batch,
                None if table is None else table.shape,
                generator=None if self.greedy else self.generator)
            self.stats.captures += 1
        return state

    def _admit(self, r: Request) -> bool:
        return True

    def _before_step(self, state, slots, active, pending):
        return state

    def _advance(self, slot: int, n_tokens: int) -> None:
        pass

    def _release(self, slot: int) -> None:
        pass

    def _post_serve(self) -> None:
        pass

    # -- live queue ----------------------------------------------------------

    def submit(self, r: Request) -> Request:
        """Enqueue one request (validated up front).  Legal at any time:
        before ``serve``, between calls, or mid-serve from a ``source``;
        the loop admits it the moment a slot (and, paged, blocks) frees."""
        self._check_capacity(r)
        if r.t_enqueue is None:
            r.t_enqueue = time.time()
        self._queue.append(r)
        return r

    def drain(self, *, max_batch: int = 8, warmup: bool = True
              ) -> EngineStats:
        """Serve everything ``submit``-ted so far and return the stats."""
        return self.serve(max_batch=max_batch, warmup=warmup)

    def _feed_source(self, source, q: queue.Queue,
                     stop: threading.Event) -> None:
        """The feeder thread: pulls from the caller's ``source`` so a slow
        iterator or callable never stalls the dispatch path (the loop only
        drains the bounded handoff queue, without blocking).  A callable
        is polled (None: exhausted, an empty batch: nothing yet);
        an iterator is pulled with the queue's bound as backpressure.  A
        sentinel marks exhaustion; an exception is handed to the loop,
        which raises it."""
        try:
            if callable(source):
                while not stop.is_set():
                    batch = source()
                    if batch is None:
                        break
                    got = False
                    for r in batch:
                        got = True
                        if not self._feed_put(q, r, stop):
                            return
                    if not got:
                        # poll at about a step's cadence, not a spin: a
                        # callable may do real work on every call
                        time.sleep(2e-3)
            else:
                for r in source:
                    if not self._feed_put(q, r, stop):
                        return
        except BaseException as e:             # noqa: BLE001 (relayed)
            self._src_err.append(e)
        finally:
            self._feed_put(q, _SOURCE_DONE, stop)

    @staticmethod
    def _feed_put(q: queue.Queue, item, stop: threading.Event) -> bool:
        """Bounded put that stays responsive to shutdown."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_FEED_TIMEOUT_S)
                return True
            except queue.Full:
                continue
        return False

    def _poll_source(self, pending: deque, max_batch: int) -> None:
        """Drain the feeder's handoff queue (never blocks).  Backpressure:
        stop once ``max_batch`` requests wait unjoined; the bounded
        handoff then throttles the feeder."""
        if self._src_err:
            self._src_done = True
            raise self._src_err[0]
        if self._src_done or self._src_q is None:
            return
        while len(pending) < max_batch:
            try:
                item = self._src_q.get_nowait()
            except queue.Empty:
                return
            if item is _SOURCE_DONE:
                self._src_done = True
                return
            self.submit(item)

    def _start_feeder(self, source, max_batch: int) -> None:
        self._src_done = source is None
        self._src_err: List[BaseException] = []
        self._src_q: Optional[queue.Queue] = None
        self._src_stop: Optional[threading.Event] = None
        self._src_thread = None
        if source is None:
            return
        self._src_q = queue.Queue(maxsize=max(2 * max_batch, 8))
        self._src_stop = threading.Event()
        self._src_thread = threading.Thread(
            target=self._feed_source,
            args=(source, self._src_q, self._src_stop),
            name="engine-source-feeder", daemon=True)
        self._src_thread.start()

    def _stop_feeder(self) -> None:
        """Stop and reap the feeder thread.  Requests it pulled from the
        caller's source that the loop never took (an exit by a deadlock
        raise or a relayed source exception) are parked in the engine
        queue, so a later ``serve``/``drain`` serves them."""
        if self._src_thread is None:
            return
        self._src_stop.set()
        self._src_thread.join(timeout=_FEEDER_JOIN_S)
        while True:
            try:
                item = self._src_q.get_nowait()
            except queue.Empty:
                break
            if item is not _SOURCE_DONE:
                try:
                    self.submit(item)
                except ValueError:
                    pass   # unservable anyway; don't mask the exit
        self._src_thread = self._src_q = self._src_stop = None

    # -- serving -------------------------------------------------------------

    def serve(self, requests: Iterable[Request] = (), *,
              source: Optional[RequestSource] = None, max_batch: int = 8,
              warmup: bool = True) -> EngineStats:
        for r in requests:
            self._check_capacity(r)
            self._queue.append(r)      # enqueue-stamped after warmup
        pending = self._queue
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._active = np.zeros(max_batch, bool)
        self._inflight = deque()
        self._live_joins = {}
        self._prefills = {}
        self._seq = getattr(self, "_seq", 0)
        self._join_seq = np.zeros(max_batch, np.int64)   # preemption order
        slots, active = self._slots, self._active
        state = self._init_pool(max_batch)

        if warmup:   # one step over the idle pool, outside the clock; it
            # leaves the generator as it found it, as JAX's warm-up step
            # (whose new state is dropped) leaves the pool's key
            rng = self.generator.get_state()
            out = HostRead(*self._run_step(state, active))
            out.get()
            self.generator.set_state(rng)
            self.stats.warmup_steps += 1

        # enqueue after the warm-up, so latency measures serving (a live
        # submit() carries its own arrival stamp)
        now = time.time()
        for r in pending:
            if r.t_enqueue is None:
                r.t_enqueue = now
        self._start_feeder(source, max_batch)
        t0 = time.time()
        # device-starvation accounting: a window opens whenever the
        # in-flight window drains and closes at the next dispatch
        self._starve_t0 = t0
        try:
            self._serve_loop(pending, max_batch, slots, active, state)
        finally:
            # reap the feeder on every exit, a deadlock raise or a relayed
            # source exception included
            self._stop_feeder()
        self.stats.wall_s += time.time() - t0
        self._post_serve()
        return self.stats

    def _serve_loop(self, pending, max_batch, slots, active, state) -> None:
        while True:
            self._poll_source(pending, max_batch)
            if (not pending and not active.any() and not self._inflight
                    and not self._prefills and self._src_done):
                break

            # harvest first where a fresh read buys better scheduling than
            # one step of overlap is worth
            while self._inflight and self._harvest_first(pending):
                self._harvest(self._inflight.popleft())

            # refill free slots before the next step (strict FIFO).  Joins
            # and chunks are dispatched behind the step in flight; a
            # join's first token is read at harvest, one step behind
            joins = []
            if self.prefill_chunk:
                state, progressed = self._advance_prefills(
                    state, slots, active, pending, joins)
            else:
                state, progressed = self._join_free_slots(
                    state, slots, active, pending, joins)
            # paged: grow block tables for the coming step, preempting the
            # most recently joined slots back into `pending` on exhaustion
            state = self._before_step(state, slots, active, pending)
            # a join preempted before its step dispatched was read and
            # requeued by _preempt; drop it from this step's record
            joins = [(si, r, tok) for si, r, tok in joins
                     if self._live_joins.get(si, (None,))[0] is r]

            if active.any():
                t_step = time.time()
                self._device_fed()
                out = HostRead(*self._run_step(state, active))
                self._inflight.append(_StepRecord(
                    out, active.copy(), list(slots), joins, max_batch,
                    t_step))
                self.stats.steps_in_flight = max(self.stats.steps_in_flight,
                                                 len(self._inflight))
                # harvest step k only once step k+1 is in the lane
                # (inflight=1: at once, the synchronous loop)
                while len(self._inflight) >= self.inflight:
                    self._harvest(self._inflight.popleft())
            elif self._inflight:
                # nothing to dispatch: drain the window; a harvested
                # finish frees slots/blocks and may unblock admission
                self._harvest(self._inflight.popleft())
            elif self._prefills or (pending and progressed):
                continue       # prefill-only interval: keep pumping chunks
            elif pending:
                raise RuntimeError(
                    "pool deadlock: no active slots and the queue head "
                    "cannot be admitted: the block pool is too small for "
                    "this request stream")
            else:
                time.sleep(2e-4)       # idle: waiting on a live source
                self._starve_t0 = time.time()   # no traffic is no stall

    def _join_free_slots(self, state, slots, active, pending, joins: list):
        """Whole-prompt joins of queue heads into free slots, each first
        token registered for a read one step later.  Returns (state,
        whether any joined)."""
        joined = False
        for si in range(len(slots)):
            if active[si] or not pending:
                continue
            if not self._admit(pending[0]):
                break              # strict FIFO: head blocks the tail
            r = pending.popleft()
            r.t_join = time.time()
            self._device_fed()
            state = self._join(state, si, r)
            joined = True
            self._register_join(si, r, state, active, joins)
        return state, joined

    def _register_join(self, si: int, r: Request, state, active,
                       joins: list) -> None:
        """Activate slot ``si`` for ``r`` after its join (or final chunk)
        and copy the first token it installed toward the host, to be read
        at the harvest of the step dispatched next."""
        self._slots[si] = r
        active[si] = True
        tok = HostRead(state.last_token[si:si + 1])
        self._live_joins[si] = (r, tok)
        joins.append((si, r, tok))

    def _harvest_first(self, pending: deque) -> bool:
        """Should the loop read an in-flight step BEFORE dispatching?

        Running ahead schedules on stale state: a request that finished
        inside the window rides a zombie step and its replacement joins a
        step late.  Harvesting first gives that back exactly where fresh
        state is worth more than one step of overlap:

          * a queued request could join now (a free slot, an admittable
            head): join and dispatch without blocking (False);
          * a queue but nothing joinable: harvest if ANY active row may
            have finished inside the window (its output plus the window's
            most commits reaches its budget), freeing a slot/blocks;
          * an empty queue (the tail): harvest only when EVERY row may be
            done, so no step runs that nobody needs.

        Scheduling only: outputs are the same either way.  EOS is not
        predicted.  With ``inflight=1`` the window is always empty here.
        """
        rows = np.where(self._active)[0]
        if rows.size == 0:
            return False
        me = self._max_emit
        possibly_done = []
        for si in rows:
            r = self._slots[si]
            k = sum(1 for rec in self._inflight
                    if rec.active[si] and rec.slots[si] is r)
            possibly_done.append(len(r.output) + k * me >= r.max_new_tokens)
        if pending:
            if not self._active.all() and self._admit(pending[0]):
                return False
            return any(possibly_done)
        return all(possibly_done)

    # -- harvest (one step behind the dispatch frontier) ---------------------

    def _device_fed(self) -> None:
        """Close an open starvation window: device work starts now."""
        if self._starve_t0 is not None:
            self.stats.host_stall_s += time.time() - self._starve_t0
            self._starve_t0 = None

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device-to-host read (the bucketed engine's); opens a
        starvation window."""
        t0 = time.time()
        out = t.cpu().numpy()
        self._starve_t0 = time.time()
        self.stats.read_wait_s += self._starve_t0 - t0
        return out

    def _vacate(self, si: int, slots, active) -> None:
        slots[si] = None
        active[si] = False
        self._release(si)

    def _harvest(self, rec: _StepRecord) -> None:
        """Read one dispatched step's emissions and apply them to the
        requests it ran over (as recorded in ``rec``: host scheduling has
        moved on since).  The loop's only wait on the device, but for a
        preemption's."""
        t0 = time.time()
        emitted, n_em = rec.out.get()      # waits for the step (and the
        t1 = time.time()                   # joins dispatched before it)
        self.stats.read_wait_s += t1 - t0
        self.stats.step_s.append(t1 - rec.t_dispatch)
        if not self._inflight and self._starve_t0 is None:
            # the window drained: host work from here to the next
            # dispatch runs beside an idle device
            self._starve_t0 = t1

        # first tokens of the joins dispatched just before this step (it
        # is done, so these reads do not wait)
        for si, r, tok in rec.joins:
            ent = self._live_joins.get(si)
            if ent is None or ent[0] is not r:
                continue                # read early by a preemption
            del self._live_joins[si]
            self._absorb_first_token(r, tok.get()[0][0])

        live = 0
        for si in np.where(rec.active)[0]:
            r = rec.slots[si]
            if not r.done:
                live += 1
                if self._slots[si] is r:   # still owns the slot (it may
                    self._advance(si, int(n_em[si]))   # have been preempted)
                appended = 0
                for t in emitted[si][:n_em[si]]:
                    # tokens past max_new_tokens are dropped even when
                    # accepted mid-step
                    if len(r.output) >= r.max_new_tokens:
                        break
                    r.output.append(int(t))
                    appended += 1
                    if r.eos_token is not None and t == r.eos_token:
                        r.done = True
                        break
                self.stats.tokens += appended
                if appended:
                    self._note_emission(r, appended)
                if r.done or len(r.output) >= r.max_new_tokens:
                    self._finish(r)
            # else: a zombie row, finished before this already dispatched
            # step was harvested; its emissions are dropped
            if r.done and self._slots[si] is r:
                self._vacate(si, self._slots, self._active)
        self.stats.steps += 1
        if rec.active.any():
            self.stats.accept_lengths.append(float(n_em[rec.active].mean()))
        self.stats.active_slot_steps += live
        self.stats.capacity_slot_steps += rec.max_batch

    def _flush_join(self, si: int) -> None:
        """Read a join's first token before its step is harvested: taken
        only when a just-joined slot is preempted, so the requeued request
        re-prefills with its first token (and only once)."""
        ent = self._live_joins.pop(si, None)
        if ent is None:
            return
        r, tok = ent
        t0 = time.time()
        tok0 = tok.get()[0][0]
        self.stats.read_wait_s += time.time() - t0
        self._absorb_first_token(r, tok0)

    def _drain_slot(self, si: int, r: Request) -> None:
        """Harvest every in-flight step in which slot ``si`` ran ``r``, so
        ``r.output`` is complete before a preemption requeues it."""
        while any(rec.active[si] and rec.slots[si] is r
                  for rec in self._inflight):
            self._harvest(self._inflight.popleft())

    def _note_emission(self, r: Request, appended: int) -> None:
        now = time.time()
        if r.t_last_emit is not None:
            gap = (now - r.t_last_emit) / appended
            self.stats.itl_s.extend([gap] * appended)
        r.t_last_emit = now

    def _absorb_first_token(self, r: Request, tok0) -> None:
        """Append a join's first token, finishing the request if that was
        its budget (1) or its EOS.  A resumed request keeps its original
        first-token time."""
        now = time.time()
        if r.t_first_token is None:
            r.t_first_token = now
            if r.t_enqueue is not None:
                self.stats.ttft_s.append(now - r.t_enqueue)
        r.t_last_emit = now
        tok0 = int(tok0)
        r.output.append(tok0)
        if (len(r.output) >= r.max_new_tokens or
                (r.eos_token is not None and tok0 == r.eos_token)):
            self._finish(r)

    def _finish(self, r: Request) -> None:
        r.done = True
        r.t_done = time.time()
        self.stats.request_latency_s.append(r.latency_s)


def _tensors(state):
    """Every tensor of a pool state (caches and per-slot rows)."""
    for x in state:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for group in x:
                yield from group.values()


class PagedSpeculativeEngine(SpeculativeEngine):
    """Continuous batching over a paged KV cache.

    Same scheduler and byte-identical greedy outputs as
    ``SpeculativeEngine``, but attention caches (and the Hydra++ prefix
    cache) live in a global block pool of ``num_blocks × block_size``
    positions.  ``num_blocks=None`` sizes the pool to the dense
    equivalent; a smaller pool oversubscribes device memory and relies on:

      * **admission control**: a queued request joins only when its
        initial coverage (padded prompt + verify scratch) plus one growth
        block per joined slot fits the free list; the queue head blocks
        the tail (strict FIFO);
      * **growth**: before every step each active slot's table is grown
        to cover ``cache_len + scratch``;
      * **preemption**: when growth exhausts the pool, the most recently
        joined slot is evicted (blocks freed, request requeued at the
        FRONT, resumed later by re-prefilling prompt + output so far).

    A request's worst-case footprint must fit the pool outright (checked
    up front), so a lone slot can always grow and preemption always makes
    progress.  Verify attention streams the pool through the paged
    tree-verify kernel; the step writes only ``max_batch × T`` scratch
    positions beyond the pool.
    """

    def __init__(self, params, draft_params, cfg: ModelConfig, tree, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 **kw):
        super().__init__(params, draft_params, cfg, tree, **kw)
        self.block_size = int(block_size)
        self.blocks_per_slot = -(-self.max_len // self.block_size)   # M
        self.num_blocks = num_blocks   # None => dense-equivalent

    def _step(self, state, active, table=None):
        if self.use_speculative:
            return paged_spec_decode_step(self.params, self.draft_params,
                                          self.cfg, self.tree, state, table,
                                          active=active, **self._sampling())
        return paged_autoregressive_step(self.params, self.cfg, state, table,
                                         active=active, **self._sampling())

    def _table(self) -> np.ndarray:
        return self._tables

    def _join(self, state, slot: int, r: Request):
        padded, n = self._padded_context(r)
        got = self._alloc.alloc(self._alloc.blocks_for(
            max(len(padded), n + self._scratch + self._stale_allowance)))
        if got is None:
            raise RuntimeError("join without free blocks: _admit must have "
                               "checked the free list")
        self._owned[slot] = got
        self._tables[slot, :] = NULL_BLOCK
        self._tables[slot, :len(got)] = got
        self._slot_len[slot] = n
        self._seq += 1
        self._join_seq[slot] = self._seq
        return paged_join_slot(self.params, self.draft_params, self.cfg,
                               state, snapshot(padded, self.device), n, slot,
                               snapshot(self._tables[slot], self.device),
                               self.generator, greedy=self.greedy)

    # -- chunked prefill over the pool (DESIGN.md §8) -------------------------

    def _dispatch_chunk(self, state, si: int, chunk: np.ndarray, start: int,
                        real_len: int, final: bool):
        view = self._chunk_view_len(start + self.prefill_chunk)
        view_blocks = min(-(-view // self.block_size), self.blocks_per_slot)
        return paged_join_slot_chunk(
            self.params, self.draft_params, self.cfg, state,
            snapshot(chunk, self.device), start, real_len, si,
            snapshot(self._tables[si], self.device), final=final,
            view_blocks=view_blocks, generator=self.generator,
            greedy=self.greedy)

    def _admit_prefill(self, r: Request) -> bool:
        """Chunked admission is priced per chunk: only the FIRST chunk's
        real-token blocks must be free (plus the one growth block of
        headroom per joined slot); later chunks allocate as they
        dispatch, so a long prompt need not find its whole footprint at
        once to start prefilling.  No stale allowance: a prefilling slot
        runs in no step; its growth before its first step is
        ``_before_step``'s, which budgets it."""
        n = len(r.prompt) + len(r.output)
        need = self._alloc.blocks_for(min(self.prefill_chunk, n))
        headroom = sum(1 for o in self._owned if o)
        return need + headroom <= self._alloc.free_blocks

    def _grow_prefill(self, si: int, job: _PrefillJob, slots, active,
                      pending) -> bool:
        """Allocate blocks covering the next chunk's REAL tokens (the final
        chunk's pads write to the NULL block and are never read).  On
        exhaustion, evict the most recent joiner, possibly ``si`` itself:
        its partial prefill is then dropped and the request requeued (the
        up-front capacity check lets a lone slot cover a whole request, so
        this ends)."""
        cover = min(job.off + self.prefill_chunk, job.real_len)
        while True:
            need = self._alloc.blocks_for(cover) - len(self._owned[si])
            if need <= 0:
                return True
            got = self._alloc.alloc(need)
            if got is not None:
                base = len(self._owned[si])
                self._owned[si].extend(got)
                self._tables[si, base:base + len(got)] = got
                return True
            victim = self._newest_joiner(slots, active)
            self._preempt(victim, slots, active, pending)
            if victim == si:
                return False

    def _advance_prefill_cursor(self, si: int, n: int) -> None:
        self._slot_len[si] = n

    # -- block accounting ----------------------------------------------------

    def _init_pool(self, max_batch: int):
        nb = self.num_blocks or 1 + max_batch * self.blocks_per_slot
        self._alloc = BlockAllocator(nb, self.block_size)
        B, M = max_batch, self.blocks_per_slot
        self._tables = np.zeros((B, M), np.int32)       # all rows -> NULL
        self._owned: List[List[int]] = [[] for _ in range(B)]
        self._slot_len = np.zeros(B, np.int64)          # committed tokens
        st = self.stats
        st.block_size = self.block_size
        st.num_blocks = nb
        st.pool_tokens = (nb - 1) * self.block_size
        st.dense_equiv_tokens = max_batch * self.max_len
        # every group streams the pool through a paged kernel (K1 or K4),
        # so the step's transient is just its scratch writes
        st.step_transient_tokens = max_batch * self._scratch
        return self._device_pool(max_batch, lambda: init_paged_state(
            self.params, self.draft_params, self.cfg, max_batch, nb,
            self.block_size, self.device))

    def _check_capacity(self, r: Request) -> None:
        # worst-case lifetime coverage: the (padded) resumed context can
        # reach prompt+budget tokens, plus one verify-scratch region, plus
        # the async staleness growth budgets per step
        worst = (self._pad_len(len(r.prompt) + r.max_new_tokens)
                 + self._scratch + self._stale_allowance)
        view_len = self.blocks_per_slot * self.block_size
        if worst > view_len:
            raise ValueError(
                f"request needs {worst} cache slots but the per-slot view "
                f"caps at {view_len} (max_len={self.max_len})")
        if self.num_blocks is not None:
            need = -(-worst // self.block_size)
            usable = self.num_blocks - 1
            if need > usable:
                raise ValueError(
                    f"request needs {need} cache blocks at its peak but the "
                    f"pool only has {usable} usable blocks "
                    f"(num_blocks={self.num_blocks} incl. the NULL block)")

    def _admit(self, r: Request) -> bool:
        n = len(r.prompt) + len(r.output)
        need = self._alloc.blocks_for(
            max(self._pad_len(n), n + self._scratch + self._stale_allowance))
        # headroom: one growth block per already-joined slot, so admitting
        # this request does not immediately force a preemption (which
        # would thrash: evict, readmit, re-prefill, evict ...)
        headroom = sum(1 for o in self._owned if o)
        return need + headroom <= self._alloc.free_blocks

    def _before_step(self, state, slots, active, pending):
        """Grow every active slot's table to cover the coming step's
        scratch region, plus the stale allowance (``_slot_len`` lags the
        device by the commits of the steps in flight); preempt
        newest-first when the pool runs dry."""
        order = sorted(np.where(active)[0], key=lambda s: self._join_seq[s])
        for si in order:
            # re-checked every round: a preemption below may evict si, or
            # its drain may harvest si's finish and release it (growing a
            # released slot would orphan the blocks)
            while active[si]:
                need = (self._alloc.blocks_for(
                    int(self._slot_len[si]) + self._scratch
                    + self._stale_allowance)
                    - len(self._owned[si]))
                if need <= 0:
                    break
                got = self._alloc.alloc(need)
                if got is not None:
                    base = len(self._owned[si])
                    self._owned[si].extend(got)
                    self._tables[si, base:base + len(got)] = got
                    break
                self._preempt(self._newest_joiner(slots, active), slots,
                              active, pending)
        return state

    def _newest_joiner(self, slots, active) -> int:
        """The eviction victim: the most recently joined slot, active or
        prefilling (a prefilling slot holds blocks too)."""
        return max((s for s in range(len(slots))
                    if active[s] or s in self._prefills),
                   key=lambda s: self._join_seq[s])

    def _preempt(self, si: int, slots, active, pending) -> None:
        """Evict slot ``si``: free its blocks and requeue its request at
        the front, to be re-prefilled from prompt + output so far.  A slot
        evicted mid-prefill never ran a step and has no first token
        pending; its resume restarts from chunk 0.  An active victim's
        output must be complete first: its join token is read if still
        pending (``_flush_join``) and every step in flight that ran it is
        harvested (``_drain_slot``), the async loop's only other waits."""
        r = slots[si]
        if self._prefills.pop(si, None) is not None:
            self._vacate(si, slots, active)
            pending.appendleft(r)
            self.stats.preemptions += 1
            return
        self._flush_join(si)
        self._drain_slot(si, r)
        if slots[si] is not r:
            # the drain found the request finished and released the slot
            active[si] = False
            return
        self._vacate(si, slots, active)
        if not r.done:
            pending.appendleft(r)       # resume ASAP, FIFO preserved
            self.stats.preemptions += 1

    def _advance(self, slot: int, n_tokens: int) -> None:
        self._slot_len[slot] += n_tokens    # host mirror of cache_len

    def _release(self, slot: int) -> None:
        if self._owned[slot]:
            self._alloc.free(self._owned[slot])
            self._owned[slot] = []
        self._tables[slot, :] = NULL_BLOCK
        self._slot_len[slot] = 0

    def _post_serve(self) -> None:
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use,
                                            self._alloc.peak_in_use)


class BucketedEngine(SpeculativeEngine):
    """The static scheduler (port of the JAX ``BucketedEngine``), kept as
    the measured baseline for the continuous engine: requests are grouped
    by exact prompt length into batches of at most ``max_batch``, and each
    batch is prefilled at once (``init_decode_state``) and stepped until
    every row is done; a finished row keeps stepping and emits nothing.
    Batches run one after another.  No active mask, no padding, no
    chunks; ``wall_s`` includes each batch's prefill."""

    def __init__(self, params, draft_params, cfg: ModelConfig, tree, *,
                 max_len: int = 2048, use_speculative: bool = True,
                 criterion: str = "greedy", temperature: float = 0.7,
                 epsilon: float = 0.15, seed: int = 0, device="cuda"):
        super().__init__(params, draft_params, cfg, tree, max_len=max_len,
                         use_speculative=use_speculative, inflight=1,
                         capture_step=False, criterion=criterion,
                         temperature=temperature, epsilon=epsilon, seed=seed,
                         device=device)

    @staticmethod
    def bucket(requests: List[Request], max_batch: int):
        by_len: dict = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        for _, group in sorted(by_len.items()):
            for i in range(0, len(group), max_batch):
                yield group[i:i + max_batch]

    def _prefill(self, prompts: np.ndarray):
        return init_decode_state(
            self.params, self.draft_params if self.use_speculative else None,
            self.cfg, torch.tensor(prompts, device=self.device).long(),
            self.max_len, self.generator, greedy=self.greedy)

    def serve(self, requests: Iterable[Request] = (), *, max_batch: int = 8,
              warmup: bool = True) -> EngineStats:
        requests = list(requests)
        batches = list(self.bucket(requests, max_batch))
        for batch in batches:
            # a finished row keeps stepping until its whole batch drains,
            # so capacity must cover the LARGEST budget in the batch per row
            need = (len(batch[0].prompt) + max(r.max_new_tokens for r in batch)
                    + self._scratch)
            if need > self.max_len:
                raise ValueError(f"batch needs {need} cache slots but "
                                 f"max_len={self.max_len}")
        if warmup and batches:  # one prefill and step, outside the clock,
            b0 = batches[0]     # leaving the generator as it found it
            rng = self.generator.get_state()
            res = self._step(self._prefill(np.zeros(
                (len(b0), len(b0[0].prompt)), np.int64)), None)
            res.n_emitted.cpu()
            self.generator.set_state(rng)
            self.stats.warmup_steps += 1
        now = time.time()
        for r in requests:
            r.t_enqueue = now
        self._starve_t0 = now
        for batch in batches:
            self._serve_batch(batch, max_batch)
        return self.stats

    def _serve_batch(self, batch: List[Request], max_batch: int) -> None:
        t0 = time.time()
        self._device_fed()
        state = self._prefill(np.stack([r.prompt for r in batch]))
        for r, t in zip(batch, self._read(state.last_token)):
            r.t_join = t0
            self._absorb_first_token(r, t)
        budget = max(r.max_new_tokens for r in batch)
        produced = 1
        while produced < budget and not all(r.done for r in batch):
            t_step = time.time()
            self._device_fed()
            res = self._step(state, None)
            state = res.state
            emitted = self._read(res.emitted)
            n_em = self._read(res.n_emitted)
            self.stats.step_s.append(time.time() - t_step)
            live = np.array([not r.done for r in batch])
            for bi, r in enumerate(batch):
                if r.done:
                    continue   # finished rows keep stepping, emit nothing
                appended = 0
                for t in emitted[bi][:n_em[bi]]:
                    if len(r.output) >= r.max_new_tokens:
                        break
                    r.output.append(int(t))
                    appended += 1
                    if r.eos_token is not None and t == r.eos_token:
                        r.done = True
                        break
                self.stats.tokens += appended
                if appended:
                    self._note_emission(r, appended)
                if r.done or len(r.output) >= r.max_new_tokens:
                    self._finish(r)
            self.stats.steps += 1
            if live.any():
                self.stats.accept_lengths.append(float(n_em[live].mean()))
            self.stats.active_slot_steps += int(live.sum())
            self.stats.capacity_slot_steps += max_batch
            produced += int(n_em.min())
        self.stats.wall_s += time.time() - t0
