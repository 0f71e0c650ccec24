"""Chunked decay linear attention (K6): the Hopper kernel's launch.

The CUDA source is ``src/repro_torch/csrc/linear_attn_chunk.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/linear_attn_chunk/kernel.py::linear_attn_chunk``), what
bounds it and how it is laid out.  Its plain versions are in ``ref.py``.
The launch takes the MODEL layout (r/k/v/w_log/o ``(B, S, H, 64)``) and
any S: positions past S read as zeros, which is the wrapper's padding
rule (k = 0, w_log = 0) done by the kernel's loads, with no padded copy.
The wrapper (``ops.py``) is the port's only caller of ``launch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIM = 64                  # dk = dv: RWKV6's wkv head
CHUNKS = (16, 64)              # chunk lengths the CUDA source instantiates
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_fn():
    """The C entry point of the built library."""
    fn = build.load("linear_attn_chunk").linear_attn_chunk
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def launch(r, k, v, w_log, u, initial_state, o, final_state, *,
           chunk: int) -> int:
    """Launch the kernel on the current CUDA stream (no synchronisation).
    All arguments must already be validated by the wrapper; ``u`` and
    ``initial_state`` may be None.  Returns the CUDA error code of the
    launch: 0 on success."""
    B, S, H, _ = k.shape
    stream = torch.cuda.current_stream(k.device).cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()
    return kernel_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(), ptr(u),
        ptr(initial_state), o.data_ptr(), final_state.data_ptr(), B, S, H,
        int(chunk), DTYPE_CODES[k.dtype], stream)
