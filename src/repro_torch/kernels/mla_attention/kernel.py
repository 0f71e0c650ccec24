"""Absorbed-MLA paged tree-verify attention (K5): the Hopper kernel's
launch.

The CUDA source is ``src/repro_torch/csrc/mla_attention_paged.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/attention_template/ops.py::mla_attention_paged_bshd``),
what bounds it and how it is laid out.  The plain version is ``ref.py``;
the wrapper (``ops.py``) is the port's only caller of ``launch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_LATENT = 512              # r the kernel takes, at most
MAX_ROWS = 16                 # padded T the kernel takes, at most
KV_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_fn():
    """The C entry point of the built library."""
    fn = build.load("mla_attention_paged").mla_attention_paged
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def launch(q, pool_lat, pool_rope, tree_lat, tree_rope, tree_mask,
           cache_len, block_table, out, *, scale: float) -> int:
    """Launch the kernel on the current CUDA stream (no synchronisation).
    ``q`` is ``[q_lat || q_rope]`` (B, T, H, r + rd) fp32, T padded; all
    arguments must already be validated by the wrapper.  Returns the CUDA
    error code of the launch: 0 on success."""
    B, T, H, _ = q.shape
    _, bs, r = pool_lat.shape
    rd = pool_rope.shape[-1]
    M = block_table.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return kernel_fn()(
        q.data_ptr(), pool_lat.data_ptr(), pool_rope.data_ptr(),
        tree_lat.data_ptr(), tree_rope.data_ptr(), tree_mask.data_ptr(),
        cache_len.data_ptr(), block_table.data_ptr(), out.data_ptr(),
        B, T, H, r, rd, bs, M, KV_DTYPE_CODES[pool_lat.dtype], float(scale),
        stream)
