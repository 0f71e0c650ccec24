"""Model-layout wrapper of the sliding-window paged tree-verify kernel K4
(port of ``repro/kernels/attention_template/ops.py::
tree_attention_paged_windowed_bshd``).

K4 is K1 (``kernels/tree_attention/``) plus absolute query positions
``q_pos`` and a window; its CUDA code is the ``kWindowed`` form of
``csrc/tree_attention_paged.cu``.  The wrapper pads T and ``q_pos`` to a
multiple of 8 as the JAX wrapper does (pad rows self-attend and sit at
position 0; their outputs are sliced away), validates the operands with
K1's checks, and dispatches on the device the tensors lie on: CPU tensors
take the plain version (``ref.py``), CUDA tensors launch the kernel or
raise, ``meta`` tensors charge the cost counter one call (``launch/
op_cost.py``) and return an empty output.  ``launches`` counts kernel
launches, and only those: one per call, the split cache sweep;
``merge_launches`` counts the merge launched after it.  The split length
is K1's (the planner's unless forced).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.attention_template.ref import (
    tree_attention_paged_windowed_plain)
from repro_torch.kernels.tree_attention import kernel as _k
from repro_torch.kernels.tree_attention.ops import (check_cuda_operands,
                                                    check_operands,
                                                    check_split_len, pad_tree,
                                                    planned_split_len,
                                                    record_paged_call)

launches = 0                  # split-sweep launches since the last reset
merge_launches = 0            # merge launches since the last reset


def tree_attention_paged_windowed_bshd(q, pool_k, pool_v, tree_k, tree_v,
                                       tree_mask, cache_len, block_table,
                                       q_pos, window: int, *,
                                       split_len: int | None = None):
    """K1's contract (q/tree k,v (B,T,H*,D); the pool (N, bs, Hkv, D)
    streamed in place; tree_mask (T,T) bool; cache_len (B,) and
    block_table (B, M) int32) plus ``q_pos`` (B, T) absolute query
    positions (any integer type; the kernel takes them as int32) and
    ``window`` (int; <= 0 means full attention, so one kernel serves
    local and global layers).  Precondition: every real query row sits
    at ``q_pos >= cache_len``.  ``split_len`` forces the kernel's split
    (default: the planner's).  Returns (B,T,Hq,D) in q's dtype."""
    global launches, merge_launches
    refuse_grad("tree_attention_paged_windowed", q, pool_k, pool_v, tree_k, tree_v)
    q, tree_k, tree_v, tree_mask, T = pad_tree(q, tree_k, tree_v, tree_mask)
    args = (q, pool_k, pool_v, tree_k, tree_v, tree_mask, cache_len,
            block_table)
    check_operands(*args)
    if q_pos.shape != (q.shape[0], T):
        raise ValueError(f"q_pos must be {(q.shape[0], T)}, got "
                         f"{tuple(q_pos.shape)}")
    q_pos = F.pad(q_pos.to(torch.int32), (0, q.shape[1] - T))
    window = int(window)
    if q.device.type == "cpu":
        out = tree_attention_paged_windowed_plain(*args, q_pos, window)
    elif q.device.type in ("cuda", "meta"):
        check_cuda_operands(*args)
        if q_pos.device != q.device:
            raise ValueError("q_pos must lie on the operands' device")
        if split_len is None:
            split_len = planned_split_len(q, pool_k.shape[2])
        check_split_len(split_len)
        out = torch.empty_like(q)
        if q.device.type == "meta":
            record_paged_call("tree_attention_paged_windowed", q, pool_k,
                              block_table, T, split_len, window)
            return out[:, :T]
        rc = _k.launch(*args, out, split_len=split_len,
                       q_pos=q_pos.contiguous(), window=window)
        if rc != 0:
            raise RuntimeError(f"tree_attention_paged_windowed launch "
                               f"failed: CUDA error {rc}")
        launches += 1
        merge_launches += 1
    else:
        raise ValueError(f"no tree_attention_paged_windowed for device "
                         f"{q.device}")
    return out[:, :T]
