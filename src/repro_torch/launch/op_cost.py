"""Op-level cost counter of one step run on the ``meta`` device (the
port's counterpart of ``repro/launch/hlo_cost.py``, which parses XLA's
HLO; the port has no HLO).

``OpCounter`` is a ``TorchDispatchMode``: every aten op the step
dispatches passes through it, and it charges

  * flops — each matmul-like op (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``addmv``; ``matmul``, ``linear`` and ``einsum``
    reach the dispatcher as these; a vector ``dot`` is not counted) as
    2·M·N·K, kept by operand
    dtype, since fp32 GEMMs run on the CUDA cores at 67 TFLOP/s and bf16
    ones on the tensor cores at 989;
  * bytes — operands plus result of each op that is not a view (an
    output that shares an operand's storage, written by no op), as
    ``hlo_cost.py`` charges fusion boundaries: the port's eager ops are
    its fusion boundaries.  Gathers (``embedding``, ``index_select``,
    ``gather``, ``index``, ``take``) are charged the rows they read, and
    in-place scatters (``index_put_``, ``scatter_``, ``index_copy_``,
    ``index_add_``...) the elements they write, not the whole tensor;
    ``copy_``, ``fill_`` and ``zero_`` do not read their destination; a
    broadcast (stride-0) operand is charged its distinct elements; an
    allocation (``empty``...) moves nothing;
  * peak live bytes — the most bytes of the tensors the step allocates
    alive at once (each new storage counted when an op makes it and
    released when it is freed), the counterpart of JAX's
    ``memory_analysis`` temp/peak.

A hand-written kernel's wrapper on ``meta`` runs neither the kernel nor
its plain version: it returns empty outputs of the kernel's shapes and
charges one call through ``record_kernel``, by the kernel's charge
function below; under autograd its backward does the same for the
backward kernels (``k6_bwd_charge``, ``flash_bwd_charge``).  Those functions are also the bounds ``chip_smoke.py``
prints for each kernel (phase 3), so a call is charged what phase 3
calls its least time.  A charge counts each operand read once and each
output written once, at the lengths the call can read; on ``meta`` no
length is known, so that is the capacity it is given.

Only tensors on ``meta`` are charged: host-side ops move no device
bytes.  Eager code runs every layer, so there are no loop trip counts to
recover (``hlo_cost.py``'s main work).
"""
from __future__ import annotations

import math
import weakref
from collections import defaultdict
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS, SFU_PER_S

aten = torch.ops.aten


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# kernel charges (shared with chip_smoke.py's bounds)
# ---------------------------------------------------------------------------


class KernelCharge(NamedTuple):
    """One kernel call's least work: the bytes it must move, its
    operations in ``dtype``, and the least time for those operations."""
    nbytes: float
    flops: float
    dtype: str
    ops_s: float


def charge(nbytes: float, flops: float, dtype: str) -> KernelCharge:
    return KernelCharge(nbytes, flops, dtype, flops / PEAK_FLOPS[dtype])


def bound_ms(c: KernelCharge) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations' least time."""
    t_bytes = c.nbytes / HBM_BW * 1e3
    t_ops = c.ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _elt(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def paged_charge(B: int, T: int, Hq: int, Hkv: int, D: int, dtype: str,
                 keys, table_entries: int, window: bool = False,
                 reads: int = 1) -> KernelCharge:
    """K1 (K4 with ``window``): the cache positions each slot reads
    (``keys``, one count per slot), each read once (``reads`` times:
    once per row group of 64 query rows, what the kernel does), plus q,
    the tree K/V and the output, the block table, ``cache_len`` and the
    mask (and K4's query positions); against the operations on those keys
    and the T tree keys."""
    elt = _elt(dtype)
    kv_bytes = sum(keys) * Hkv * D * 2 * elt * reads
    io_bytes = (2 * B * T * Hq * D + 2 * B * T * Hkv * D) * elt
    small = table_entries * 4 + B * 4 + T * T + (B * T * 4 if window else 0)
    flops = sum(4 * Hq * T * D * (k + T) for k in keys)
    return charge(kv_bytes + io_bytes + small, flops, dtype)


def dense_charge(B: int, T: int, Hq: int, Hkv: int, D: int, dtype: str,
                 keys, reads: int = 1) -> KernelCharge:
    """K2: each slot's keys below ``cache_len`` read once (``reads``
    times: once per row group), plus q, the tree K/V and the output,
    against the operations on those keys and the tree."""
    elt = _elt(dtype)
    kv_bytes = sum(keys) * Hkv * D * 2 * elt * reads
    io_bytes = (2 * B * T * Hq * D + 2 * B * T * Hkv * D) * elt
    flops = sum(4 * Hq * T * D * (n + T) for n in keys)
    return charge(kv_bytes + io_bytes + B * 4 + T * T, flops, dtype)


def mla_charge(B: int, T: int, H: int, r: int, rd: int, dtype: str, keys,
               table_entries: int) -> KernelCharge:
    """K5: the latent and rope cache positions each slot reads, each read
    once, plus q (fp32), the tree latents and the output (fp32), against
    (r + rd) + r multiply-adds per admitted (head, row, key), the T tree
    keys included."""
    elt = _elt(dtype)
    dk = r + rd
    nbytes = (sum(keys) * dk * elt + B * T * H * dk * 4 + B * T * dk * elt
              + B * T * H * r * 4 + table_entries * 4 + B * 4 + T * T)
    flops = sum(2 * H * T * (k + T) * (dk + r) for k in keys)
    return charge(nbytes, flops, dtype)


def k3_pairs(S: int, window: int, causal: bool = True) -> int:
    """Admitted (query, key) pairs of an S x S run (causal, or both ways
    without a window)."""
    if not causal:
        return S * S
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def chunk_rows(q_off: int, C: int, window: int) -> tuple:
    """(admitted (query, key) pairs, distinct keys read) of C causal rows
    at ``q_off``, ``q_off + 1``, ... over keys 0.. ."""
    rows = range(q_off, q_off + C)
    if window <= 0:
        return sum(i + 1 for i in rows), q_off + C
    return (sum(min(i + 1, window) for i in rows),
            q_off + C - max(0, q_off - window + 1))


def flash_charge(B: int, Sq: int, keys: int, Hq: int, Hkv: int, dqk: int,
                 dv: int, dtype: str, pairs: int) -> KernelCharge:
    """K3: q and the output of Sq rows, the ``keys`` key/value rows it
    reads, each once, against 2 (dqk + dv) operations per admitted
    (head, query, key) pair (``pairs`` per row of the batch)."""
    nbytes = B * (Sq * Hq * (dqk + dv) + keys * Hkv * (dqk + dv)) * _elt(
        dtype)
    return charge(nbytes, 2 * (dqk + dv) * Hq * B * pairs, dtype)


def flash_bwd_charge(B: int, S: int, Hq: int, Hkv: int, dqk: int, dv: int,
                     dtype: str, pairs: int) -> KernelCharge:
    """K3's backward over a whole prefill of S rows: q, k, v, the output,
    its cotangent and the log-sum-exp (fp32) read once, dq, dk and dv
    written once, against the products it cannot do without per admitted
    (head, query, key) pair (``pairs`` per row of the batch): the scores
    recomputed (2 dqk), dP = dO V^T (2 dv), dV += P^T dO (2 dv), dK +=
    dS^T Q and dQ += dS K (2 dqk each)."""
    elt = _elt(dtype)
    nbytes = B * S * (Hq * (2 * dqk + 2 * dv) * elt + Hq * 4
                      + 2 * Hkv * (dqk + dv) * elt)
    return charge(nbytes, 2 * (3 * dqk + 2 * dv) * Hq * B * pairs, dtype)


def k6_bwd_charge(B: int, S: int, H: int, d: int, dtype: str,
                  u: bool = True, s0: bool = False,
                  d_state: bool = False) -> KernelCharge:
    """K6's backward (dk = dv = d), what the gradient needs: r, k, v and
    the output's cotangent read in their type and the log-decay in fp32,
    dr, dk, dv written in their type and dw in fp32, each once; u read
    and du written (fp32) with ``u``, the initial state read and its
    gradient written with ``s0``, the final state's cotangent read with
    ``d_state``.  The states entering each chunk, which the forward saves
    and the kernel reads, are left out: they follow from k, v and w.  Its
    operations: one exponential per token and channel on the SFUs, and
    its least products, 8 dk dv a token (the gradients of the state's
    read-out and update), on the tensor cores in bf16 and the CUDA cores
    in fp32."""
    elt = _elt(dtype)
    nbytes = (B * S * H * d * (7 * elt + 8)
              + B * H * d * d * 4 * (2 * s0 + d_state)
              + (2 * H * d * 4 if u else 0))
    products = 8 * B * S * H * d * d
    ops_s = max(B * S * H * d / SFU_PER_S, products / PEAK_FLOPS[dtype])
    return KernelCharge(nbytes, products, dtype, ops_s)


def k6_flops(S: int, c: int, H: int, d: int) -> int:
    """fp32 operations of one K6 call at B=1 in the pairwise chunked form
    with chunk ``c`` (c = 1 is the sequential recurrence), per head: the
    state read-out r S and the state update k v^T at 2 per multiply-add
    (4 dk dv a token), the state's decay once a chunk (dk dv), the strict
    lower pairs of each chunk at 5 per channel (difference, exponential,
    two products, sum) plus 2 per column of A v, and per token the decay's
    exponential and the u-bonus (4 dk + 2 dv)."""
    full, rest = divmod(S, c)
    pairs = full * c * (c - 1) // 2 + rest * (rest - 1) // 2
    per_head = (4 * S * d * d + -(-S // c) * d * d + pairs * (5 * d + 2 * d)
                + S * (4 * d + 2 * d))
    return H * per_head


def k6_charge(B: int, S: int, H: int, d: int, dtype: str) -> KernelCharge:
    """K6 (dk = dv = d): r, k, v read and o written in their type, the
    log-decay, both states and u in fp32, each once.

    fp32: against the least fp32 operations over the exact forms, the
    chunked form at every chunk length 1..64 (``k6_flops``; least at
    chunk 4), on the CUDA cores' fp32 peak (the kernel runs its products
    in 3xTF32 on the tensor cores, so this is conservative; the bytes
    bound it either way).
    bf16: the kernel runs its products on the tensor cores, so the least
    time for its operations is the larger of the exponentials the
    function needs on the SFUs (one per token and channel: every decay
    factor is a product of exp(w)) and its least products (the state
    read-out and update, 4 dk dv a token) at the tensor cores' rate."""
    elt = _elt(dtype)
    nbytes = (B * (4 * S * H * d * elt + S * H * d * 4 + 2 * H * d * d * 4)
              + H * d * 4)
    if elt == 4:
        return charge(nbytes, B * min(k6_flops(S, c, H, d)
                                      for c in range(1, 65)), "float32")
    products = 4 * B * S * H * d * d
    ops_s = max(B * S * H * d / SFU_PER_S, products / PEAK_FLOPS[dtype])
    return KernelCharge(nbytes, products, dtype, ops_s)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_MATMUL = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.addmm: 1,
           aten.baddbmm: 1, aten.addmv: 1}        # op -> its left operand
_GATHER = {aten.embedding, aten.index_select, aten.gather, aten.index,
           aten.take}
# in-place scatters: op -> the argument holding the values written
_SCATTER = {aten.index_put_: 2, aten._index_put_impl_: 2, aten.scatter_: 3,
            aten.scatter_add_: 3, aten.scatter_reduce_: 3,
            aten.index_copy_: 3, aten.index_add_: 3}
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}

_ACTIVE: list = []          # the counters in force, innermost last


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a stride-0 dim adds
    none)."""
    return math.prod(s for s, st in zip(t.shape, t.stride())
                     if st != 0) * t.element_size()


def _meta_tensors(items) -> list:
    """The distinct meta tensors among ``items`` and the lists/tuples in
    them (an op's arguments and results nest no deeper)."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            if x.is_meta and all(x is not t for t in out):
                out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in _meta_tensors(x)
                       if all(t is not u for u in out))
    return out


_MUTATES: dict = {}          # op overload -> writes one of its arguments


def _mutates(func) -> bool:
    m = _MUTATES.get(func)
    if m is None:
        m = _MUTATES[func] = any(
            a.alias_info is not None and a.alias_info.is_write
            for a in func._schema.arguments)
    return m


def record_kernel(name: str, c: KernelCharge, **shape) -> None:
    """Charge one call of kernel ``name`` to the counter in force (none:
    nothing is recorded).  ``shape`` keeps the arguments the charge was
    computed from."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, c, shape)


class OpCounter(TorchDispatchMode):
    """Counts the flops by dtype, the bytes, the peak live bytes and the
    kernel calls of the ops dispatched while it is in force:

        with OpCounter() as oc:
            step(*meta_args)
        oc.flops, oc.bytes, oc.peak_live_bytes, oc.t_roof_s
    """

    def __init__(self):
        super().__init__()
        self.flops = defaultdict(float)     # dtype name -> operations
        self.bytes = 0.0
        self.compute_s = 0.0                # least time of the operations
        self.kernels = []                   # (name, KernelCharge, shape)
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live = {}                     # id(storage) -> bytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def t_roof_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    def add_kernel(self, name: str, c: KernelCharge, shape: dict) -> None:
        self.kernels.append((name, c, shape))
        self.flops[c.dtype] += c.flops
        self.bytes += c.nbytes
        self.compute_s += c.ops_s

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, in_storages: set) -> None:
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in in_storages or key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(s, self._free, key)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = _meta_tensors((*args, *kwargs.values()))
        outs = _meta_tensors(out if isinstance(out, (list, tuple))
                             else (out,))
        if not ins and not outs:
            return
        self.n_ops += 1
        packet = func.overloadpacket
        in_storages = {id(t.untyped_storage()) for t in ins}
        if not _mutates(func) and outs and all(
                id(t.untyped_storage()) in in_storages for t in outs):
            return                                          # a view
        self._track(outs, in_storages)
        if packet in _ALLOC:
            return
        if packet in _MATMUL:
            a = args[_MATMUL[packet]]
            n = 2 * outs[0].numel() * a.shape[-1]
            dt = dtype_name(a.dtype)
            self.flops[dt] += n
            self.compute_s += n / PEAK_FLOPS[dt]
        if packet in _GATHER:
            src = args[0]
            self.bytes += 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins if t is not src)
        elif packet in _SCATTER:
            dst, vals = args[0], args[_SCATTER[packet]]
            written = _nbytes(vals) if isinstance(vals, torch.Tensor) else 0
            self.bytes += written + sum(_nbytes(t) for t in ins
                                        if t is not dst)
        elif packet in _WRITE_ONLY:
            dst = args[0]
            self.bytes += _nbytes(dst) + sum(_nbytes(t) for t in ins
                                             if t is not dst)
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)

    def kernel_summary(self) -> dict:
        """``{kernel: {"calls", "bytes", "flops", "ops_s"}}``."""
        out = {}
        for name, c, _ in self.kernels:
            e = out.setdefault(name, {"calls": 0, "bytes": 0.0,
                                      "flops": 0.0, "ops_s": 0.0})
            e["calls"] += 1
            e["bytes"] += c.nbytes
            e["flops"] += c.flops
            e["ops_s"] += c.ops_s
        return out
