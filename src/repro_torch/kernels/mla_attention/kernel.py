"""Absorbed-MLA paged tree-verify attention (K5): the Hopper kernel's
launch.

The CUDA source is ``src/repro_torch/csrc/mla_attention_paged.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/attention_template/ops.py::mla_attention_paged_bshd``),
what bounds it and how it is laid out.  The same source carries the
windowed form (``launch(..., q_pos=, window=)``, entry point
``mla_attention_paged_windowed``).  Each launch is two kernels: the split
cache sweep and the merge; ``scratch`` allocates the merge's fp32
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

# The split kernel's blocks, mirrored from the .cu (tests/
# test_torch_mla_f32_rules.py holds them against its text): 64 query rows
# a block in four 16-row tiles, 16 warps (each row tile's four quarters
# split the score's contraction and the output columns) and key tiles of
# 16, in both bodies; the fp32 (3xTF32) body's rows unpadded in shared
# memory, their 16-byte chunks permuted instead.
GROUP_ROWS = 64
THREADS = 512
KEYS = 16
MAX_SMEM = 232448              # shared memory a block may opt into


def f32_row(dk: int) -> int:
    """Floats of a row of q or of a key tile in the fp32 build's shared
    memory (the .cu's ``f32_row``): dk padded to a multiple of 32."""
    return -(-dk // 32) * 32


def f32_smem_bytes(r: int, rd: int) -> int:
    """Shared memory a block of the fp32 build at widths (r, rd) takes
    (the .cu's ``f32_smem_bytes``): q's 64 rows and a ring of two 16-key
    tiles, ``f32_row(r + rd)`` floats a row, one n8 block of the 16 warps'
    partial scores (16 x 8 each), then three tiles' key rows (int)."""
    floats = ((GROUP_ROWS + 2 * KEYS) * f32_row(r + rd)
              + (THREADS // 32) * 4 * 32)
    return 4 * floats + 4 * 3 * KEYS


def kernel_fn(windowed: bool = False):
    """The C entry point of K5, or of its windowed form."""
    name = "mla_attention_paged_windowed" if windowed else \
        "mla_attention_paged"
    fn = getattr(build.load("mla_attention_paged"), name)
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        n_ptr, n_int = (13, 11) if windowed else (12, 10)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
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
           split_len: int, q_pos=None, window=None) -> int:
    """Launch the split sweep at ``split_len`` and the merge on the current
    CUDA stream (no synchronisation); the windowed form when ``q_pos``
    (B, T) int32 and ``window`` (int) are given.  ``q_lat``/``q_rope`` are
    fp32 (B, T, H, r) / (B, T, H, rd), any T up to 16; all arguments must
    already be validated by the wrapper.  Returns the CUDA error code of
    the launches: 0 on success."""
    B, T, H, r = q_lat.shape
    _, bs, _ = pool_lat.shape
    rd = pool_rope.shape[-1]
    M = block_table.shape[1]
    part_ml, part_acc = scratch(B, T, H, r, M * bs, split_len, q_lat.device)
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    ptrs = (q_lat.data_ptr(), q_rope.data_ptr(), pool_lat.data_ptr(),
            pool_rope.data_ptr(), tree_lat.data_ptr(), tree_rope.data_ptr(),
            tree_mask.data_ptr(), cache_len.data_ptr(),
            block_table.data_ptr())
    parts = (out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr())
    split = (split_len, n_splits(M * bs, split_len))
    code = KV_DTYPE_CODES[pool_lat.dtype]
    if q_pos is not None:
        return kernel_fn(windowed=True)(
            *ptrs, q_pos.data_ptr(), *parts, B, T, H, r, rd, bs, M,
            int(window), *split, code, float(scale), stream)
    return kernel_fn()(*ptrs, *parts, B, T, H, r, rd, bs, M, *split, code,
                       float(scale), stream)
