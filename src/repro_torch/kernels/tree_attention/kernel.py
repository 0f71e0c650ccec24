"""Paged tree-verify attention (K1): the Hopper kernel's launch and its
plain PyTorch version.

The CUDA source is ``src/repro_torch/csrc/tree_attention_paged.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/tree_attention/kernel.py::tree_attention_paged``), what
bounds it and how it is laid out.  The same source carries the windowed
form K4, whose launch is here too (``launch(..., q_pos=, window=)``); its
plain version and wrapper live in ``kernels/attention_template/``.
``tree_attention_paged_plain`` is a torch port of
``repro/kernels/tree_attention/ref.py::
tree_attention_paged_ref``: the slot's logical view gathered through the
block table, NULL-table positions and positions past ``cache_len``
masked.  The CPU tests run it and ``chip_smoke.py`` holds the kernel
against it on the card.

Both take the MODEL layout (q/out ``(B, T, Hq, D)``, tree K/V
``(B, T, Hkv, D)``) with T already padded by the wrappers (``ops.py``
here, ``attention_template/ops.py`` for K4), the port's only callers of
``launch``.  Each launch is two kernels: the split cache sweep and the
merge (``split.py`` has the planner and the split's plain version); the
wrappers allocate the merge's fp32 scratch (``scratch``).

The same source carries the dense-cache form K2 as well (entry point
``tree_attention_dense``): ``launch_dense`` starts it and
``tree_attention_dense_plain`` is its plain version, the dense verify the
port ran before K2 (the tree K/V written into a copy of the cache at
``[cache_len, cache_len + T)``, then ``masked_attention`` under the
verify mask), so the CPU path keeps its numbers.  Its wrapper is
``dense_ops.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tree_attention.split import n_splits
from repro_torch.models.layers import masked_attention

NULL_BLOCK = 0                 # physical pool block 0 is never read unmasked
HEAD_DIMS = (64, 128, 256)     # the head dims the CUDA source instantiates
MAX_ROWS = 64                  # G * T query rows a block holds (4 warps x 16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _entry(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.load("tree_attention_paged"), name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def kernel_fn(windowed: bool = False):
    """The C entry point of K1, or of K4 when ``windowed``."""
    if windowed:
        return _entry("tree_attention_paged_windowed", 12, 11)
    return _entry("tree_attention_paged", 11, 10)


def dense_kernel_fn():
    """K2's C entry point (the dense form of the same library)."""
    return _entry("tree_attention_dense", 10, 9)


def scratch(q, Hkv: int, capacity: int, split_len: int):
    """The merge's fp32 scratch for a call on q (B, T, Hq, D): per
    (b, kv head), ``n_splits + 1`` partials (the splits, then the tree) of
    R = G*T rows: (m, l) pairs and D accumulator columns."""
    B, T, Hq, D = q.shape
    shape = (B * Hkv, n_splits(capacity, split_len) + 1, (Hq // Hkv) * T)
    return (torch.empty((*shape, 2), dtype=torch.float32, device=q.device),
            torch.empty((*shape, D), dtype=torch.float32, device=q.device))


def launch(q, pool_k, pool_v, tree_k, tree_v, tree_mask, cache_len,
           block_table, out, *, split_len: int, q_pos=None,
           window=None) -> int:
    """Launch K1, or K4 when ``q_pos`` (B, T) int32 and ``window`` (int)
    are given, on the current CUDA stream (no synchronisation): the split
    sweep at ``split_len``, then the merge.  All arguments must already be
    validated by the wrapper.  Returns the CUDA error code of the
    launches: 0 on success."""
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = pool_k.shape
    M = block_table.shape[1]
    part_ml, part_acc = scratch(q, Hkv, M * bs, split_len)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            tree_k.data_ptr(), tree_v.data_ptr(), tree_mask.data_ptr(),
            cache_len.data_ptr(), block_table.data_ptr())
    split = (split_len, n_splits(M * bs, split_len))
    scale = 1.0 / math.sqrt(D)
    if q_pos is not None:
        return kernel_fn(windowed=True)(
            *ptrs, q_pos.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), B, T, Hq, Hkv, D, bs, M, int(window),
            *split, DTYPE_CODES[q.dtype], scale, stream)
    return kernel_fn()(
        *ptrs, out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        B, T, Hq, Hkv, D, bs, M, *split, DTYPE_CODES[q.dtype], scale, stream)


def launch_dense(q, cache_k, cache_v, tree_k, tree_v, tree_mask, cache_len,
                 out, *, split_len: int) -> int:
    """Launch K2 on the current CUDA stream (no synchronisation); the
    cache is the per-slot (B, S, Hkv, D) layer view.  All arguments must
    already be validated by the wrapper.  Returns the CUDA error code of
    the launches: 0 on success."""
    B, T, Hq, D = q.shape
    S, Hkv = cache_k.shape[1], cache_k.shape[2]
    part_ml, part_acc = scratch(q, Hkv, S, split_len)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return dense_kernel_fn()(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        tree_k.data_ptr(), tree_v.data_ptr(), tree_mask.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), B, T, Hq, Hkv, D, S, split_len,
        n_splits(S, split_len), DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D),
        stream)


def tree_attention_dense_plain(q, cache_k, cache_v, tree_k, tree_v,
                               tree_mask, cache_len):
    """q: (B,T,Hq,D); cache_k/v: (B,S,Hkv,D); tree_k/v: (B,T,Hkv,D);
    tree_mask: (T,T) bool; cache_len: (B,) int.  Returns (B,T,Hq,D) in
    q's dtype.

    The tree K/V go into a copy of the cache at ``[cache_len, cache_len +
    T)`` (writes past S dropped), then ``masked_attention`` runs under
    the verify mask: cache positions below ``cache_len``, and tree token
    j for row i where ``tree_mask[i, j]``.  Masked weights are exact
    zeros, so a finite value at a masked position cannot change the
    result; ``masked_attention`` multiplies rather than selects, so NaN or
    inf there would."""
    B, T = q.shape[:2]
    S = cache_k.shape[1]
    dev = q.device
    slot = cache_len[:, None].long() + torch.arange(T, device=dev)[None, :]
    ok = slot < S
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    ck, cv = cache_k.clone(), cache_v.clone()
    ck[bidx[ok], slot[ok]] = tree_k[ok].to(ck.dtype)
    cv[bidx[ok], slot[ok]] = tree_v[ok].to(cv.dtype)
    kv_pos = torch.arange(S, device=dev)
    in_past = kv_pos[None, :] < cache_len[:, None]                  # (B,S)
    j = kv_pos[None, :] - cache_len[:, None]
    in_tree = (j >= 0) & (j < T)
    tree_bit = tree_mask[:, torch.clamp(j, 0, T - 1)].permute(1, 0, 2)
    mask = (in_past[:, None, :] & ~in_tree[:, None, :]) | (
        in_tree[:, None, :] & tree_bit)                             # (B,T,S)
    return masked_attention(q, ck, cv, mask)


def tree_attention_paged_plain(q, pool_k, pool_v, tree_k, tree_v, tree_mask,
                               cache_len, block_table):
    """q: (B,T,Hq,D); pool_k/v: (N,bs,Hkv,D); tree_k/v: (B,T,Hkv,D);
    tree_mask: (T,T) bool; cache_len: (B,) int; block_table: (B,M) int.
    Returns (B,T,Hq,D) in q's dtype.

    Excluded positions are removed by selection, never by multiplication:
    scores become -inf and weights 0 through ``torch.where``, and the
    gathered K/V are selected to 0 as well, because ``0 * NaN`` is NaN and
    a NULL block may hold NaN or inf."""
    B, T, Hq, D = q.shape
    bs, Hkv = pool_k.shape[1], pool_k.shape[2]
    M = block_table.shape[1]
    G = Hq // Hkv
    S = M * bs
    table = block_table.long()
    ck = pool_k[table].reshape(B, S, Hkv, D)
    cv = pool_v[table].reshape(B, S, Hkv, D)
    kv_pos = torch.arange(S, device=q.device)
    covered = (table != NULL_BLOCK).repeat_interleave(bs, dim=1)
    in_cache = covered & (kv_pos[None, :] < cache_len[:, None])     # (B,S)
    keep = torch.cat([in_cache, torch.ones((B, T), dtype=torch.bool,
                                           device=q.device)], dim=1)
    keep4 = keep[:, :, None, None]
    kx = torch.where(keep4, torch.cat([ck, tree_k], dim=1).float(), 0.0)
    vx = torch.where(keep4, torch.cat([cv, tree_v], dim=1).float(), 0.0)
    mask = torch.cat([in_cache[:, None, :].expand(B, T, S),
                      tree_mask[None].expand(B, T, T)], dim=2)      # (B,T,S+T)
    mask = mask[:, :, None, None, :]
    qf = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bthgs", qf, kx) / math.sqrt(D)
    s = torch.where(mask, s, -math.inf)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bthgs,bshd->bthgd", p, vx)
    return out.reshape(B, T, Hq, D).to(q.dtype)
