"""The decode step captured as one CUDA graph, and the serve loop's host
transfers (DESIGN.md §5, §7).

The JAX engine runs its step as one compiled executable per
``(max_batch, tree)``; the port's counterpart is ``CapturedStep``: one
``torch.cuda.CUDAGraph`` of the whole step (draft, verify forward with
its kernels, acceptance, commit), captured once per engine and pool
shape and replayed every step.  The engine keys it by ``max_batch``
alone: the tree, the layout (dense or paged), ``use_speculative``, the
acceptance ``criterion`` and its ``temperature`` and ``epsilon`` are
fixed per engine, so a new capture is taken only when ``serve`` is
called with another ``max_batch``.

A graph reads and writes fixed addresses, so the step runs *in place*
(``step_in_place``): its inputs are the pool state's own tensors (the
caches, which the step already commits in place, and ``cache_len``,
``last_token``, ``last_hidden``, into which the step's new values are
copied at its end), plus two static buffers the host fills before each
replay: the ``active`` mask and, for the paged engine, the block table.
Joins and prefill chunks run eagerly between replays and write into the
same tensors, never rebinding them.  The outputs ``emitted`` and
``n_emitted`` are static too: each replay overwrites the previous one's,
so the caller copies them out (``HostRead``) before the next replay.

The eager step and the replay run the same operators on the same
operands in the same order, so their results are bitwise equal; a
capture or replay that fails raises, and nothing falls back to the eager
step.

A sampling step draws inside the graph from the engine's CUDA
generator, which is registered with the graph
(``CUDAGraph.register_generator_state``): each replay reads the
generator's offset when it is launched and advances it by the draws of
one step, so two replays never repeat their draws, and a replay draws
the numbers the eager step would draw from the same generator state.
The capture's eager warm-up consumes draws and the capture itself
reserves none; the constructor saves the generator's state before the
warm-up and restores it after the capture, so a captured engine and an
eager one with the same seed and schedule draw the same numbers.

The serve loop never waits on the stream except where it reads a
result: host operands go up from pinned copies without blocking
(``snapshot``, ``upload``) and results come down into pinned buffers
behind an event (``HostRead``), so a step in flight is never drained by
a transfer queued behind it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import kernels


def _pinned_copy(host_array: np.ndarray) -> torch.Tensor:
    """A pinned host tensor holding a copy of ``host_array``.  The copy
    is owned by the returned tensor alone, so no later host write can
    reach a transfer still queued from it; the caching host allocator
    hands the pinned block out again only once the transfer that read it
    has run."""
    return torch.from_numpy(np.array(host_array)).pin_memory()


def snapshot(host_array: np.ndarray, device) -> torch.Tensor:
    """Device operand from a MUTABLE host array, copy-guaranteed.

    The host keeps rewriting the ``active`` mask and the block tables
    while a step may still be queued on the device, so the operand is
    taken from a private host copy (the aliasing race of the JAX
    engine's ``_snapshot``).  On CUDA the upload is queued without
    waiting for the stream: a blocking copy would wait for every step
    in flight."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(host_array)).to(device)
    return _pinned_copy(host_array).to(device, non_blocking=True)


def upload(dst: torch.Tensor, host_array: np.ndarray) -> None:
    """``dst.copy_(host_array)`` from a private host copy, queued on the
    current stream without waiting for it."""
    dst.copy_(_pinned_copy(host_array), non_blocking=True)


class HostRead:
    """Device tensors' current values, copied to the host in stream order
    behind one event (on the CPU: clones).  ``get()`` waits for those
    copies alone, never for work queued after them, so the loop can read
    step k while step k+1 runs."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [t.clone() for t in tensors]

    def get(self) -> tuple:
        """The values as numpy arrays, in the order given."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(h.numpy() for h in self.host)


def step_in_place(step, state, active, table):
    """Run ``step(state, active, table) -> StepResult`` and copy the new
    ``cache_len``, ``last_token`` and ``last_hidden`` into ``state``'s own
    tensors (the caches are committed in place by the step itself).
    Returns the step's ``(emitted, n_emitted)``."""
    res = step(state, active, table)
    for name in ("cache_len", "last_token", "last_hidden"):
        getattr(state, name).copy_(getattr(res.state, name))
    return res.emitted, res.n_emitted


class CapturedStep:
    """One decode step over ``state``, captured as a CUDA graph.

    ``step(state, active, table) -> StepResult`` is the engine's eager
    step; ``table_shape`` is the block table's (B, M) for the paged
    layout, None for the dense one.  The constructor runs one eager
    warm-up step on a side stream with every row inactive (it builds and
    loads the kernels, sets their launch attributes, creates the library
    handles and fills the tree's index cache; an all-inactive step
    changes no committed state), then captures the step with
    ``torch.cuda.graph``.  The kernels' Python launch counters count the
    warm-up and the capture, not the replays: ``launches`` holds the
    counts of the capture alone (the launches one replay makes),
    ``replays`` the replays since construction.  ``generator``: the CUDA
    generator a sampling step draws from (None: a step that draws
    nothing), registered with the graph and left in the state it had
    before the warm-up."""

    def __init__(self, step, state, max_batch: int,
                 table_shape: Optional[tuple] = None,
                 generator: Optional[torch.Generator] = None):
        dev = state.cache_len.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA state, not {dev}")
        self.state = state
        self.active = torch.zeros(max_batch, dtype=torch.bool, device=dev)
        self.table = (torch.zeros(table_shape, dtype=torch.int32, device=dev)
                      if table_shape is not None else None)
        self.replays = 0
        self.generator = generator
        rng = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step_in_place(step, state, self.active, self.table)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph):
            self.emitted, self.n_emitted = step_in_place(
                step, state, self.active, self.table)
        after = kernels.launch_counts()
        if generator is not None:
            generator.set_state(rng)
        self.launches = {k: after[k] - before[k] for k in after}

    def __call__(self, active: np.ndarray,
                 table: Optional[np.ndarray] = None):
        """Replay over the host ``active`` mask (and block table): both
        are uploaded into the static buffers first, in stream order.
        Returns the static ``(emitted, n_emitted)``, valid until the next
        replay."""
        upload(self.active, active)
        if self.table is not None:
            upload(self.table, table)
        self.graph.replay()
        self.replays += 1
        return self.emitted, self.n_emitted
