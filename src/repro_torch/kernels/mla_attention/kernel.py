"""Absorbed-MLA paged tree-verify attention (K5): the Hopper kernel's
launch.

The CUDA source is ``src/repro_torch/csrc/mla_attention_paged.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/attention_template/ops.py::mla_attention_paged_bshd``),
what bounds it and how it is laid out.  Each launch is two kernels: the
split cache sweep and the merge; ``scratch`` allocates the merge's fp32
partials, and ``kernels/tree_attention/split.py::plan_mla_split_len`` the
split.  The plain versions are in ``ref.py``; the wrapper (``ops.py``) is
the port's only caller of ``launch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tree_attention.split import n_splits

WIDTHS = ((512, 64), (64, 16))  # (latent, rope) widths the source builds
MAX_TREE = 16                 # T the kernel takes, at most
KV_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_fn():
    """The C entry point of the built library."""
    fn = build.load("mla_attention_paged").mla_attention_paged
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def scratch(B: int, T: int, H: int, r: int, capacity: int, split_len: int,
            device):
    """The merge's fp32 scratch: per slot, ``n_splits + 1`` partials (the
    splits, then the tree) of the R = T*H rows: (m, l) pairs and r
    accumulator columns."""
    shape = (B, n_splits(capacity, split_len) + 1, T * H)
    return (torch.empty((*shape, 2), dtype=torch.float32, device=device),
            torch.empty((*shape, r), dtype=torch.float32, device=device))


def launch(q_lat, q_rope, pool_lat, pool_rope, tree_lat, tree_rope,
           tree_mask, cache_len, block_table, out, *, scale: float,
           split_len: int) -> int:
    """Launch the split sweep at ``split_len`` and the merge on the current
    CUDA stream (no synchronisation).  ``q_lat``/``q_rope`` are fp32
    (B, T, H, r) / (B, T, H, rd), any T up to 16; all arguments must
    already be validated by the wrapper.  Returns the CUDA error code of
    the launches: 0 on success."""
    B, T, H, r = q_lat.shape
    _, bs, _ = pool_lat.shape
    rd = pool_rope.shape[-1]
    M = block_table.shape[1]
    part_ml, part_acc = scratch(B, T, H, r, M * bs, split_len, q_lat.device)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    return kernel_fn()(
        q_lat.data_ptr(), q_rope.data_ptr(), pool_lat.data_ptr(),
        pool_rope.data_ptr(), tree_lat.data_ptr(), tree_rope.data_ptr(),
        tree_mask.data_ptr(), cache_len.data_ptr(), block_table.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        B, T, H, r, rd, bs, M, split_len, n_splits(M * bs, split_len),
        KV_DTYPE_CODES[pool_lat.dtype], float(scale), stream)
