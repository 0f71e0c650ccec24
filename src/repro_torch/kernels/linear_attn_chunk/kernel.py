"""Chunked decay linear attention (K6): the Hopper kernel's launch.

The CUDA source is ``src/repro_torch/csrc/linear_attn_chunk.cu``; its
header says which TPU kernel it replaces
(``repro/kernels/linear_attn_chunk/kernel.py::linear_attn_chunk``), what
bounds it and how it is laid out.  Its plain versions are in ``ref.py``.
The launch takes the MODEL layout (r/k/v/w_log/o ``(B, S, H, 64)``) and
any S: positions past S read as zeros, which is the wrapper's padding
rule (k = 0, w_log = 0) done by the kernel's loads, with no padded copy.
Each launch is two kernels, the chunk-parallel pass and the scan of the
state across chunks, joined by fp32 scratch that ``scratch`` allocates;
given ``states`` (``states_buffer``), the scan also writes the state
entering each chunk there, for the backward.  Both run their products on
the tensor cores: bf16 on mma.sync.m16n8k16 (fp32 operands as two bf16
parts), fp32 on m16n8k8 in 3xTF32 (``csrc/tf32_mma.cuh``).

The backward (``launch_bwd``, source ``csrc/linear_attn_chunk_bwd.cu``,
replacing no TPU kernel) is four kernels in either dtype: each chunk's
increment of the state's gradient, the carry of that gradient across the
chunks, the chunk-parallel gradient pass on the tensor cores (fp32 in
3xTF32) and, with u, du's reduction; all joined by the fp32 scratch
``bwd_scratch`` allocates.  Its
plain version is ``ref.py::decay_attention_chunked_bwd``.  The wrapper
(``ops.py``) is the port's only caller of ``launch`` and ``launch_bwd``.
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
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def bwd_fn():
    """The C entry point of the built backward library."""
    fn = build.load("linear_attn_chunk_bwd").linear_attn_chunk_bwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def scratch(B: int, S: int, H: int, chunk: int, device):
    """The fp32 scratch the chunk kernel writes and the scan reads, per
    (b, h, chunk): q_eff and o_intra (chunk x 64 each), the state
    increment (64 x 64) and the decay (64)."""
    nc = -(-S // chunk)
    f = lambda *s: torch.empty((B, H, nc, *s), dtype=torch.float32,
                               device=device)
    return (f(chunk, HEAD_DIM), f(chunk, HEAD_DIM), f(HEAD_DIM, HEAD_DIM),
            f(HEAD_DIM))


def states_buffer(B: int, S: int, H: int, chunk: int, device):
    """Where the scan writes the fp32 state entering each chunk, (B, H,
    n_chunks, 64, 64): the backward's ``states``."""
    nc = -(-S // chunk)
    return torch.empty((B, H, nc, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                       device=device)


def bwd_scratch(B: int, S: int, H: int, chunk: int, device, with_u: bool):
    """The backward's fp32 scratch: each chunk's dS_out (B, H, n_chunks,
    64, 64), which holds the chunk's increment of it until the carry
    writes dS_out there for the gradient pass, each chunk's decay
    exp(L_last) (B, H, n_chunks, 64), which the increment kernel writes
    for the carry, and, with u, du's per-chunk partials (B, H, n_chunks,
    64)."""
    nc = -(-S // chunk)
    f = lambda *s: torch.empty((B, H, nc, *s), dtype=torch.float32,
                               device=device)
    return (f(HEAD_DIM, HEAD_DIM), f(HEAD_DIM),
            f(HEAD_DIM) if with_u else None)


def launch(r, k, v, w_log, u, initial_state, o, final_state, *,
           chunk: int, states=None) -> int:
    """Launch the chunk kernel and then the scan on the current CUDA
    stream (no synchronisation).  All arguments must already be validated
    by the wrapper; ``u``, ``initial_state`` and ``states`` may be None.
    Returns the CUDA error code of the launches: 0 on success."""
    B, S, H, _ = k.shape
    stream = torch.cuda.current_stream(k.device).cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()
    work = scratch(B, S, H, chunk, k.device)
    return kernel_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(), ptr(u),
        ptr(initial_state), o.data_ptr(), final_state.data_ptr(),
        *(t.data_ptr() for t in work), ptr(states), B, S, H, int(chunk),
        DTYPE_CODES[k.dtype], stream)


def launch_bwd(r, k, v, w_log, u, states, do, d_state, dr, dk, dv, dw, du,
               d_s0, *, chunk: int) -> int:
    """Launch the backward's kernels on the current CUDA stream (no
    synchronisation): the gradients of r, k, v (their dtype), w_log, u
    and the initial state (fp32) into ``dr`` .. ``d_s0``, from the
    forward's ``states`` and the cotangents ``do`` (v's dtype) and
    ``d_state`` (fp32, or None: zero).  ``u`` and ``du`` are None
    together.  All arguments must already be validated by the wrapper.
    Returns the CUDA error code of the launches: 0 on success."""
    B, S, H, _ = k.shape
    stream = torch.cuda.current_stream(k.device).cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()
    ds_out, decay, du_part = bwd_scratch(B, S, H, chunk, k.device,
                                         u is not None)
    return bwd_fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(), ptr(u),
        states.data_ptr(), do.data_ptr(), ptr(d_state), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), ptr(du),
        d_s0.data_ptr(), ds_out.data_ptr(), decay.data_ptr(), ptr(du_part),
        B, S, H, int(chunk), DTYPE_CODES[k.dtype], stream)
