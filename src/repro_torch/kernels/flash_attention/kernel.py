"""Prefill attention (K3): the Hopper kernel's launch and its plain
PyTorch version.

The CUDA source is ``src/repro_torch/csrc/flash_attention.cu``; its header
says which TPU kernel it replaces
(``repro/kernels/flash_attention/kernel.py::flash_attention``), what
bounds it and how it is laid out.  ``flash_attention_plain`` is the port's
``blocked_attention`` (``models/layers.py``) with ``q_pos = kv_pos =
arange(S)``: the full-seq math the port ran before K3, so the CPU path
keeps its numbers.  The CPU tests run it and ``chip_smoke.py`` holds the
kernel against it on the card.

Both take the MODEL layout: q/out ``(B, S, Hq, D)``, k/v
``(B, S, Hkv, D)``.  The wrapper (``ops.py``) is the port's only caller of
``launch``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import blocked_attention

# head dim -> query rows one thread block holds (G * the query tile): the
# G query heads of a kv head must fit in one block
MAX_ROWS = {64: 128, 128: 128, 256: 64}
HEAD_DIMS = tuple(MAX_ROWS)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_fn():
    """The C entry point of the built library."""
    fn = build.load("flash_attention").flash_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def launch(q, k, v, out, *, causal: bool, window: int,
           scale: float | None = None) -> int:
    """Launch the kernel on the current CUDA stream (no synchronisation).
    All arguments must already be validated by the wrapper.  ``scale``
    defaults to 1/sqrt(D).  Returns the CUDA error code of the launch: 0
    on success."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, Hq, Hkv, D, int(causal), int(window), DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(D) if scale is None else float(scale), stream)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None):
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D); query and key i sit at position i;
    ``scale`` defaults to 1/sqrt(D).  Returns (B,S,Hq,D) in q's dtype."""
    B, S = q.shape[:2]
    pos = torch.arange(S, device=q.device)
    return blocked_attention(q, k, v, pos[None].expand(B, S), pos,
                             window=window, causal=causal, scale=scale)
