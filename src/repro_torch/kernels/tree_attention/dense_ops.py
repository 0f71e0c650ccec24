"""Model-layout wrapper of the dense tree-verify kernel K2 (port of
``repro/kernels/tree_attention/ops.py::tree_attention_bshd``).

K2 is K1's function over the per-slot dense cache ``(B, S, Hkv, D)``
instead of the block pool: keys below ``cache_len[b]`` of slot b's row,
then the T tree keys under the ancestor mask.  Its CUDA code is the
``kDense`` form of ``csrc/tree_attention_paged.cu``.  The wrapper pads T
to a multiple of 8 as K1's does (pad rows self-attend; sliced away),
validates the operands, and dispatches on the device the tensors lie on:
CPU tensors take the plain version
(``kernel.py::tree_attention_dense_plain``), CUDA tensors launch the
kernel or raise, ``meta`` tensors charge the cost counter one call
(``launch/op_cost.py``) and return an empty output.  ``launches``
counts kernel launches, and only those: one per call, the split cache
sweep; ``merge_launches`` counts the merge launched after it.  A dense
call gets the split a K1 call of the same shapes gets (``split.py``),
whatever the two capacities.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.tree_attention import kernel as _k
from repro_torch.kernels.tree_attention.ops import (check_cuda_shape,
                                                    check_split_len,
                                                    pad_tree,
                                                    planned_split_len)
from repro_torch.launch.op_cost import dense_charge, dtype_name, record_kernel

launches = 0                  # split-sweep launches since the last reset
merge_launches = 0            # merge launches since the last reset


def check_operands(q, cache_k, cache_v, tree_k, tree_v, tree_mask,
                   cache_len):
    B, T, Hq, D = q.shape
    if cache_k.dim() != 4 or cache_k.shape[0] != B \
            or cache_k.shape[3] != D or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be ({B}, S, Hkv, {D}), got "
                         f"{tuple(cache_k.shape)} / {tuple(cache_v.shape)}")
    Hkv = cache_k.shape[2]
    if tree_k.shape != (B, T, Hkv, D) or tree_v.shape != tree_k.shape:
        raise ValueError(f"tree K/V must be {(B, T, Hkv, D)}, got "
                         f"{tuple(tree_k.shape)} / {tuple(tree_v.shape)}")
    if Hq % Hkv != 0:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if tree_mask.shape != (T, T) or tree_mask.dtype != torch.bool:
        raise ValueError(f"tree_mask must be ({T}, {T}) bool")
    if cache_len.shape != (B,):
        raise ValueError("cache_len must be (B,)")


def check_cuda_operands(q, cache_k, cache_v, tree_k, tree_v, tree_mask,
                        cache_len):
    tensors = (q, cache_k, cache_v, tree_k, tree_v, tree_mask, cache_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must lie on one CUDA device")
    if q.dtype not in _k.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype for t in (cache_k, cache_v, tree_k, tree_v)):
        raise ValueError("q, caches and tree K/V must share one dtype")
    if cache_len.dtype != torch.int32:
        raise ValueError("cache_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous operands only")
    check_cuda_shape(q, cache_k.shape[2])


def tree_attention_bshd(q, cache_k, cache_v, tree_k, tree_v, tree_mask,
                        cache_len, *, split_len: int | None = None):
    """q/tree k,v: (B,T,H*,D) model layout; cache_k/v: the per-slot
    cache (B, S, Hkv, D), read only below ``cache_len`` (B,) int32;
    tree_mask (T,T) bool.  ``split_len`` forces the kernel's split (a
    multiple of 16; default: the planner's).  Returns (B,T,Hq,D) in q's
    dtype."""
    global launches, merge_launches
    refuse_grad("tree_attention_dense", q, cache_k, cache_v, tree_k, tree_v)
    q, tree_k, tree_v, tree_mask, T = pad_tree(q, tree_k, tree_v, tree_mask)
    args = (q, cache_k, cache_v, tree_k, tree_v, tree_mask, cache_len)
    check_operands(*args)
    if q.device.type == "cpu":
        out = _k.tree_attention_dense_plain(*args)
    elif q.device.type in ("cuda", "meta"):
        check_cuda_operands(*args)
        if split_len is None:
            split_len = planned_split_len(q, cache_k.shape[2])
        check_split_len(split_len)
        out = torch.empty_like(q)
        if q.device.type == "meta":
            # at capacity, every slot reads its whole row of S keys; the
            # merge's scratch is allocated as the launch allocates it
            B, S, Hkv, D = cache_k.shape
            _k.scratch(q, Hkv, S, split_len)
            shape = dict(B=B, T=T, Hq=q.shape[2], Hkv=Hkv, D=D,
                         dtype=dtype_name(q.dtype), keys=[S] * B)
            record_kernel("tree_attention_dense", dense_charge(**shape),
                          **shape)
            return out[:, :T]
        rc = _k.launch_dense(*args, out, split_len=split_len)
        if rc != 0:
            raise RuntimeError(f"tree_attention_dense launch failed: CUDA "
                               f"error {rc}")
        launches += 1
        merge_launches += 1
    else:
        raise ValueError(f"no tree_attention_dense for device {q.device}")
    return out[:, :T]
