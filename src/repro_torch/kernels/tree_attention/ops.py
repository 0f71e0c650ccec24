"""Model-layout wrapper of the paged tree-verify kernel (port of
``repro/kernels/tree_attention/ops.py::tree_attention_paged_bshd``).

The wrapper pads the tree axis T (pad rows self-attend, so their softmax
is well defined), validates what the kernel takes, and dispatches on the
device the tensors lie on: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.  There is no fallback from one to the
other.  ``meta`` tensors take neither: the call returns an empty output
and charges the cost counter (``launch/op_cost.py``) one call.
``launches`` counts kernel launches, and only those: one per call,
the split cache sweep; ``merge_launches`` counts the merge kernel each call
launches after it.  The split length comes from the planner
(``split.py::plan_split_len``, through ``planned_split_len``) unless the
caller forces one.  Any number of query rows per kv head is taken: the
kernel cuts them into row groups of 64.  The padding, the checks and the
planned split are shared with the windowed wrapper (K4,
``kernels/attention_template/ops.py``) and the dense one (K2,
``dense_ops.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.tree_attention import kernel as _k
from repro_torch.kernels.tree_attention.split import (plan_split_len,
                                                      row_groups)
from repro_torch.launch.op_cost import dtype_name, paged_charge, record_kernel

launches = 0                  # split-sweep launches since the last reset
merge_launches = 0            # merge launches since the last reset
T_PAD = 8                     # the tree axis is padded to a multiple of this


def pad_tree_mask(tree_mask, Tp: int):
    """The (T, T) ancestor mask grown to (Tp, Tp); padded query rows
    attend only to themselves, so their softmax is well defined.  Built
    from slice copies: an index assignment here synchronised the host
    with the card on every padded call."""
    T = tree_mask.shape[0]
    dev = tree_mask.device
    tm = torch.zeros((Tp, Tp), dtype=torch.bool, device=dev)
    tm[:T, :T] = tree_mask
    tm[T:, T:] = torch.eye(Tp - T, dtype=torch.bool, device=dev)
    return tm


def pad_tree(q, tree_k, tree_v, tree_mask):
    """Pad the tree axis T up to a multiple of ``T_PAD``; padded query
    rows attend only to themselves."""
    T = q.shape[1]
    Tp = -(-T // T_PAD) * T_PAD
    if Tp == T:
        return q, tree_k, tree_v, tree_mask, T
    pad = lambda t: F.pad(t, (0, 0, 0, 0, 0, Tp - T))
    return pad(q), pad(tree_k), pad(tree_v), pad_tree_mask(tree_mask, Tp), T


def check_operands(q, pool_k, pool_v, tree_k, tree_v, tree_mask, cache_len,
                   block_table):
    B, T, Hq, D = q.shape
    N, bs, Hkv, Dk = pool_k.shape
    if pool_v.shape != pool_k.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q {tuple(q.shape)}")
    if tree_k.shape != (B, T, Hkv, D) or tree_v.shape != tree_k.shape:
        raise ValueError(f"tree K/V must be {(B, T, Hkv, D)}, got "
                         f"{tuple(tree_k.shape)} / {tuple(tree_v.shape)}")
    if Hq % Hkv != 0:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if tree_mask.shape != (T, T) or tree_mask.dtype != torch.bool:
        raise ValueError(f"tree_mask must be ({T}, {T}) bool")
    if cache_len.shape != (B,) or block_table.dim() != 2 \
            or block_table.shape[0] != B:
        raise ValueError("cache_len must be (B,) and block_table (B, M)")
    if bs % 8 != 0:
        raise ValueError(f"pool block_size {bs} must be a multiple of 8")


def check_cuda_operands(q, pool_k, pool_v, tree_k, tree_v, tree_mask,
                        cache_len, block_table):
    tensors = (q, pool_k, pool_v, tree_k, tree_v, tree_mask, cache_len,
               block_table)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one CUDA device")
    if q.dtype not in _k.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype for t in (pool_k, pool_v, tree_k, tree_v)):
        raise ValueError("q, pools and tree K/V must share one dtype")
    if cache_len.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise ValueError("cache_len and block_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous operands only")
    check_cuda_shape(q, pool_k.shape[2])


def check_cuda_shape(q, Hkv: int) -> None:
    """What the kernel cannot take: a head dim it has no build for, or a
    grid past its extent, more (b, kv head) pairs or more row groups of
    the G*T query rows (T padded) than ``MAX_GRID``."""
    B, T, Hq, D = q.shape
    if D not in _k.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_k.HEAD_DIMS}")
    if B * Hkv > _k.MAX_GRID:
        raise ValueError(f"{B * Hkv} (b, kv head) pairs exceed the "
                         f"kernel grid's {_k.MAX_GRID}")
    rows = (Hq // Hkv) * -(-T // T_PAD) * T_PAD
    if row_groups(rows) > _k.MAX_GRID:
        raise ValueError(f"{row_groups(rows)} row groups of {rows} query "
                         f"rows per kv head exceed the kernel grid's "
                         f"{_k.MAX_GRID}")


def planned_split_len(q, Hkv: int) -> int:
    """The planner's split for a call on q (B, T, Hq, D), T padded: its
    B*Hkv blocks per split column times the row groups of G*T rows."""
    B, T, Hq, _ = q.shape
    return plan_split_len(B, Hkv, row_groups((Hq // Hkv) * T))


def check_split_len(split_len: int) -> None:
    if split_len <= 0 or split_len % 16 != 0:
        raise ValueError(f"split_len {split_len} must be a positive "
                         "multiple of 16")


def record_paged_call(name: str, q, pool_k, block_table, T: int,
                      split_len: int, window: int = 0) -> None:
    """Charge a paged tree-verify call on ``meta`` (K1, or K4 with
    ``window``) at the capacity its block table reaches: M blocks of
    ``block_size`` keys a slot (at most ``window - 1`` with a window), T
    the tree's real size; and allocate the merge's scratch the launch
    allocates, so the counter sees it live."""
    B, M = block_table.shape
    _, bs, Hkv, D = pool_k.shape
    _k.scratch(q, Hkv, M * bs, split_len)
    cap = M * bs if window <= 0 else min(M * bs, window - 1)
    shape = dict(B=B, T=T, Hq=q.shape[2], Hkv=Hkv, D=D,
                 dtype=dtype_name(q.dtype), keys=[cap] * B,
                 table_entries=B * M, window=window)
    record_kernel(name, paged_charge(**shape), block_size=bs, **shape)


def tree_attention_paged_bshd(q, pool_k, pool_v, tree_k, tree_v, tree_mask,
                              cache_len, block_table, *,
                              split_len: int | None = None):
    """q/tree k,v: (B,T,H*,D) model layout; pool_k/v: the global pool
    (num_blocks, block_size, Hkv, D), streamed in place, never gathered
    on the card; tree_mask (T,T) bool; cache_len (B,) and block_table
    (B, M) int32.  ``split_len`` forces the kernel's split (a multiple of
    16; default: the planner's).  Returns
    (B,T,Hq,D) in q's dtype."""
    global launches, merge_launches
    refuse_grad("tree_attention_paged", q, pool_k, pool_v, tree_k, tree_v)
    q, tree_k, tree_v, tree_mask, T = pad_tree(q, tree_k, tree_v, tree_mask)
    args = (q, pool_k, pool_v, tree_k, tree_v, tree_mask, cache_len,
            block_table)
    check_operands(*args)
    if q.device.type == "cpu":
        out = _k.tree_attention_paged_plain(*args)
    elif q.device.type in ("cuda", "meta"):
        check_cuda_operands(*args)
        if split_len is None:
            split_len = planned_split_len(q, pool_k.shape[2])
        check_split_len(split_len)
        out = torch.empty_like(q)
        if q.device.type == "meta":
            record_paged_call("tree_attention_paged", q, pool_k, block_table,
                              T, split_len)
            return out[:, :T]
        rc = _k.launch(*args, out, split_len=split_len)
        if rc != 0:
            raise RuntimeError(f"tree_attention_paged launch failed: CUDA "
                               f"error {rc}")
        launches += 1
        merge_launches += 1
    else:
        raise ValueError(f"no tree_attention_paged for device {q.device}")
    return out[:, :T]
