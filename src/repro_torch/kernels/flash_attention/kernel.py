"""Prefill attention (K3): the Hopper kernel's launch and its plain
PyTorch version.

The CUDA source is ``src/repro_torch/csrc/flash_attention.cu``; its header
says which TPU kernel it replaces
(``repro/kernels/flash_attention/kernel.py::flash_attention``), what
bounds it and how it is laid out.  ``flash_attention_plain`` is the port's
``blocked_attention`` (``models/layers.py``) with ``q_pos = q_off +
arange(Sq)`` and ``kv_pos = arange(Skv)``, as JAX's chunked-prefill
continuation calls it (``repro/models/attention.py::
_prefill_continuation``); a whole prefill (``q_off = 0``, ``Skv = Sq``, no
``kv_valid_len``) keeps the numbers of the full-seq math the port ran
before K3.  The CPU tests run it and ``chip_smoke.py`` holds the kernel
against it on the card.

Both take the MODEL layout: q ``(B, Sq, Hq, Dqk)``, k ``(B, Skv, Hkv,
Dqk)``, v ``(B, Skv, Hkv, Dv)``, out ``(B, Sq, Hq, Dv)``; ``q_off`` and
``kv_valid_len`` are ``(B,)`` int32.  Under autograd the launch also
writes each row's log-sum-exp (``lse``, (B, Hq, Sq) fp32), which the
backward reads.

The backward of a whole prefill (``launch_bwd``, source
``csrc/flash_attention_bwd.cu``, replacing no TPU kernel: JAX
differentiates ``blocked_attention``) is dQ by query tiles (which also
writes delta = rowsum(dO o)), then dK/dV by key tiles and query heads
and, with more query than kv heads or a split walk (``bwd_split``), the
sum of the fp32 partials, in bf16 and in fp32 alike.  Every (Dqk, Dv) of
``DIMS`` has a build in both types (``F32_DIMS`` in fp32); nothing is
padded.
``flash_attention_lse_plain`` and
``flash_attention_bwd_plain`` are its plain versions, in the same
decomposition (each kv head's dK/dV summed over its query heads in
order, as the kernels sum their per-head partials).  The wrapper
(``ops.py``) is the port's only caller of ``launch`` and
``launch_bwd``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import blocked_attention

# (Dqk, Dv) of the builds, in bf16 and in fp32 (both on the tensor cores,
# fp32 in 3xTF32); (80, 80) is hubert-xlarge's encoder, (192, 128)
# deepseek's MLA prefill at its own widths.  fp32 also builds (48, 32),
# deepseek-v2-lite's reduced MLA widths, which the narrow fp32 runs on
# the card take (``chip_smoke.py`` phase 4, the captured-step tests)
DIMS = ((64, 64), (80, 80), (128, 128), (256, 256), (192, 128))
F32_DIMS = DIMS + ((48, 32),)
# the body's key tile (keys a shared-memory tile): the candidates, the
# rows of a query tile (a consumer warpgroup's: the granularity at which a
# chunk's rows equal the whole prefill's bit for bit), and the shared
# memory a block may take (the .cu's kMaxSmem); a build has a tile where
# its ring fits (``mma_smem_bytes``) and, in bf16, its accumulators
# (``ACC_FLOATS``)
TILE_CANDIDATES = (32, 64, 128)
MMA_ROWS = 64
MAX_SMEM = 227 * 1024
SMS = 132                      # the H100 SXM's streaming multiprocessors
WGMMA_DQ_MAX = 192             # the widest dQ on wgmma (the .cu's kWgmmaDqMax)
# the bf16 body (the .cu's constants): one or two consumer warpgroups of
# 64 rows each a block (beside one producer warp issuing the TMA loads),
# a ring of STAGES K/V stages, and the fp32 registers a thread may give
# O, S and P (``acc_floats``) with one consumer warpgroup and with two
MAX_WARPGROUPS = 2
STAGES = 2
ACC_FLOATS = 176
TWO_WG_FLOATS = 120


def _blocks(d: int) -> int:
    """The 64-column blocks of a width in the bf16 body's tiles."""
    return -(-d // 64)


def acc_floats(dv: int, kn: int) -> int:
    """The registers O, S and P take a bf16 thread at key tile ``kn``
    (the .cu's ``acc_floats``): O, S, and P in bf16 pairs, 64 rows over
    a warpgroup's 128 threads."""
    return dv // 2 + kn // 2 + kn // 4


def warpgroups(dv: int, kn: int) -> int:
    """A bf16 instance's consumer warpgroups (the .cu's ``warpgroups``):
    two, each of 64 query positions, reading each K/V tile once for 128,
    where O, S and P take at most ``TWO_WG_FLOATS`` floats a thread (a
    block of 288 threads counts as three warpgroups: 168 registers a
    thread); else one, and one at dv = 64, whose 64-row blocks fit two an
    SM."""
    return (MAX_WARPGROUPS if dv > 64 and acc_floats(dv, kn) <= TWO_WG_FLOATS
            else 1)


def mma_smem_bytes(dqk: int, dv: int, kn: int, dtype=torch.bfloat16) -> int:
    """The body's shared memory (the .cu's ``mma_smem_bytes``).  bf16
    (``WgLayout``): 1024 bytes of alignment slack, each consumer
    warpgroup's 64 rows of q, then ``STAGES`` stages of K and of V tiles
    of ``kn`` keys, every tile in blocks of 64 columns (80 takes two) x
    128 bytes a row, and the stages' four mbarriers each (K and V
    arrived, K and V given back) and q's, 8 bytes each.  fp32: q's 64
    rows, then rings of two K and two V tiles of ``kn`` keys, each row
    padded by 4 floats, each of its 4 warp pairs' P (16 rows of kn + 8
    floats) and 8 warps' 16 row maxima."""
    if dtype != torch.float32:
        return (1024 + warpgroups(dv, kn) * MMA_ROWS * 128 * _blocks(dqk)
                + STAGES * kn * 128 * (_blocks(dqk) + _blocks(dv))
                + 8 * (4 * STAGES + 1))
    return 4 * ((MMA_ROWS + 2 * kn) * (dqk + 4) + 2 * kn * (dv + 4)
                + 4 * 16 * (kn + 8) + 8 * 16)


def tile_fits(dqk: int, dv: int, kn: int) -> bool:
    """Whether the bf16 (dqk, dv) build has a key tile of ``kn`` (the
    .cu's ``mma_fits``): its ring fits a block's shared memory, and O, S
    and P hold at most ``ACC_FLOATS`` floats a thread (128 keys at dv =
    256 would spill)."""
    return (mma_smem_bytes(dqk, dv, kn) <= MAX_SMEM
            and acc_floats(dv, kn) <= ACC_FLOATS)


def check_tma(name: str, shape, strides, data_ptr: int,
              itemsize: int) -> None:
    """Raise unless a bf16 operand of ``shape`` and element ``strides``
    at address ``data_ptr`` is what the body's TMA loads take: contiguous
    (the C entry point encodes its tensor map from the shape alone), its
    base on a 16-byte boundary, and every stride of the map (a row of
    ``shape[-1]`` elements and its multiples) a multiple of 16 bytes."""
    want, n = [], 1
    for d in reversed(shape):
        want.append(n)
        n *= d
    want.reverse()
    if any(d > 1 and s != w for d, s, w in zip(shape, strides, want)):
        raise ValueError(f"{name}: the kernel's TMA loads take contiguous "
                         f"operands only, got strides {tuple(strides)} at "
                         f"shape {tuple(shape)}")
    if data_ptr % 16:
        raise ValueError(f"{name}: the kernel's TMA loads need a base on a "
                         f"16-byte boundary, got {data_ptr:#x}")
    if shape[-1] * itemsize % 16:
        raise ValueError(f"{name}: the kernel's TMA loads need rows of a "
                         f"multiple of 16 bytes, got {shape[-1]} x "
                         f"{itemsize}")


# each bf16 build's key tiles (its template instances), and its default:
# 64, the autotuner's winner at most of the registry's keys.
# Each fp32 build has one key tile, not tuned: the widest whose ring fits,
# at most 64 (one mask bit a score of a thread; the .cu's
# ``launch_build``)
KEY_TILES = {dims: tuple(n for n in TILE_CANDIDATES if tile_fits(*dims, n))
             for dims in DIMS}
DEFAULT_KEY_TILE = {dims: 64 for dims in DIMS}
F32_KEY_TILE = {dims: 64 if mma_smem_bytes(*dims, 64, torch.float32)
                <= MAX_SMEM else 32 for dims in F32_DIMS}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def f32_rows(dqk: int) -> int:
    """The fp32 backward kernels' rows a block (keys for dK/dV, queries
    for dQ; the .cu's ``f32_rows``): 64, or 32 at Dqk = 256."""
    return 32 if dqk >= 256 else 64


def kernel_fn():
    """The C entry point of the built library."""
    fn = build.load("flash_attention").flash_attention
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def bwd_fn():
    """The C entry point of the built backward library."""
    fn = build.load("flash_attention_bwd").flash_attention_bwd
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def launch(q, k, v, out, *, causal: bool, window: int,
           scale: float | None = None, q_off=None, kv_valid_len=None,
           key_tile: int = 0, lse=None) -> int:
    """Launch the kernel on the current CUDA stream (no synchronisation).
    All arguments must already be validated by the wrapper; ``q_off`` and
    ``kv_valid_len`` are (B,) int32 on q's device, or None (offset 0,
    every key valid).  ``scale`` defaults to 1/sqrt(Dqk).  ``key_tile``
    selects the bf16 body's instance (one of ``KEY_TILES[(Dqk, Dv)]``;
    fp32 ignores it: ``F32_KEY_TILE``).  ``lse`` (B, Hq, Sq) fp32, or
    None: where the
    kernel writes each row's log-sum-exp.  Returns the CUDA error code of
    the launch: 0 on success."""
    B, Sq, Hq, Dqk = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr(lse),
        ptr(q_off), ptr(kv_valid_len), B, Sq, Skv, Hq, Hkv, Dqk, Dv,
        int(causal), int(window), DTYPE_CODES[q.dtype], int(key_tile),
        1.0 / math.sqrt(Dqk) if scale is None else float(scale), stream)


def bwd_split(B: int, S: int, Hq: int, dqk: int, dv: int, dtype) -> int:
    """The blocks sharing one key tile's queries (dK/dV) and one query
    tile's keys (dQ): 2 where one block per (query head, tile) would leave
    SMs idle, else 1.  The tile is 64 positions in the bf16 kernels on
    wgmma (head dims multiples of 64; gemma3-1b's 4 query heads at S =
    1024: 64 blocks) and ``f32_rows`` in fp32 (every build; gemma3-1b at
    S = 512: 64 blocks of 32 keys); 1 for the other bf16 builds."""
    if dtype == torch.float32:
        return 2 if B * Hq * -(-S // f32_rows(dqk)) < SMS else 1
    if dqk % 64 or dv % 64:
        return 1
    return 2 if B * Hq * -(-S // 64) < SMS else 1


def bwd_scratch(B: int, S: int, Hq: int, Hkv: int, dqk: int, dv: int,
                dtype, device):
    """The backward's fp32 scratch: delta = rowsum(dO o), (B, Hq, S), and,
    with Hq > Hkv or a split (``bwd_split``), the partials before their
    sum (None otherwise): each query head's and share's dK and dV, B * S *
    Hq * split * (dqk + dv) floats, and with a split of a dQ kernel that
    takes one (fp32; bf16 on wgmma, dqk <= ``WGMMA_DQ_MAX``) each share's
    dQ, B * S * Hq * split * dqk more."""
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=device)
    split = bwd_split(B, S, Hq, dqk, dv, dtype)
    part = None
    if Hq != Hkv or split > 1:
        dq_split = dtype == torch.float32 or dqk <= WGMMA_DQ_MAX
        dq = dqk if split > 1 and dq_split else 0
        part = torch.empty((B * S * Hq * split * (dqk + dv + dq),),
                           dtype=torch.float32, device=device)
    return delta, part


def launch_bwd(q, k, v, out, lse, do, dq, dk, dv, *, causal: bool,
               window: int, scale: float) -> int:
    """Launch the backward's kernels on the current CUDA stream (no
    synchronisation): the gradients of a whole prefill's q, k and v into
    ``dq``, ``dk``, ``dv`` from the forward's ``out`` and ``lse`` and the
    output's cotangent ``do``.  All arguments must already be validated
    by the wrapper.  Returns the CUDA error code of the launches: 0 on
    success."""
    B, S, Hq, Dqk = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    delta, part = bwd_scratch(B, S, Hq, Hkv, Dqk, Dv, q.dtype, q.device)
    return bwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if part is None else
        part.data_ptr(), B, S, Hq, Hkv, Dqk, Dv, int(causal), int(window),
        DTYPE_CODES[q.dtype], bwd_split(B, S, Hq, Dqk, Dv, q.dtype),
        float(scale), stream)


def _admitted(q0: int, q1: int, k0: int, k1: int, causal: bool,
              window: int, device):
    """(q1 - q0, k1 - k0) bool: key j admitted by query i (positions)."""
    dq = (torch.arange(q0, q1, device=device)[:, None]
          - torch.arange(k0, k1, device=device)[None])
    ok = torch.ones_like(dq, dtype=torch.bool)
    if causal:
        ok &= dq >= 0
    if window > 0:
        ok &= dq < window
    return ok


def flash_attention_lse_plain(q, k, *, causal: bool = True, window: int = 0,
                              scale: float | None = None, tile: int = 64):
    """A whole prefill's row log-sum-exp of the scaled scores over the
    admitted keys, (B, Hq, S) fp32, by query tiles: what the kernel's
    forward writes under autograd."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    out = []
    for q0 in range(0, S, tile):
        q1 = min(S, q0 + tile)
        s = torch.einsum("bthgd,bshd->bthgs", qf[:, q0:q1], k.float()) * scale
        ok = _admitted(q0, q1, 0, S, causal, window, q.device)
        s = torch.where(ok[None, :, None, None], s, -math.inf)
        out.append(torch.logsumexp(s, dim=-1))
    return torch.cat(out, dim=1).reshape(B, S, Hq).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                              window: int = 0, scale: float | None = None,
                              tile: int = 64):
    """The gradients (dq, dk, dv), fp32, of a whole prefill in the backward
    kernels' decomposition: delta = rowsum(dO o); per (query tile, key
    tile), P = exp(scale q k^T - lse) where admitted and dS = P (dO v^T -
    delta); dK/dV per key tile and query head over every query tile, then
    each kv head's G query heads summed in order (g = 0 first); dQ per
    query tile over the key tiles."""
    B, S, Hq, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, S, Hkv, G, Dv)
    delta = (dof * out.float().reshape(B, S, Hkv, G, Dv)).sum(-1)
    lse_ = lse.float().reshape(B, Hkv, G, S).permute(0, 3, 1, 2)

    def scores(q0, q1, k0, k1):
        s = torch.einsum("bthgd,bshd->bthgs", qf[:, q0:q1],
                         kf[:, k0:k1]) * scale
        ok = _admitted(q0, q1, k0, k1, causal, window, q.device)
        p = torch.where(ok[None, :, None, None],
                        torch.exp(s - lse_[:, q0:q1, ..., None]), 0.0)
        dp = torch.einsum("bthgv,bshv->bthgs", dof[:, q0:q1], vf[:, k0:k1])
        return p, p * (dp - delta[:, q0:q1, ..., None])

    dq = torch.zeros_like(qf)
    dk_h = torch.zeros((B, S, Hkv, G, D), device=q.device)
    dv_h = torch.zeros((B, S, Hkv, G, Dv), device=q.device)
    tiles = [(t0, min(S, t0 + tile)) for t0 in range(0, S, tile)]
    for k0, k1 in tiles:                 # dK and dV by key tiles and heads
        for q0, q1 in tiles:
            p, ds = scores(q0, q1, k0, k1)
            dv_h[:, k0:k1] += torch.einsum("bthgs,bthgv->bshgv", p,
                                           dof[:, q0:q1])
            dk_h[:, k0:k1] += scale * torch.einsum("bthgs,bthgd->bshgd", ds,
                                                   qf[:, q0:q1])
    dk, dv = dk_h[..., 0, :].clone(), dv_h[..., 0, :].clone()
    for g in range(1, G):                # the group's sum, in order
        dk += dk_h[..., g, :]
        dv += dv_h[..., g, :]
    for q0, q1 in tiles:                 # dQ by query tiles
        for k0, k1 in tiles:
            _, ds = scores(q0, q1, k0, k1)
            dq[:, q0:q1] += scale * torch.einsum("bthgs,bshd->bthgd", ds,
                                                 kf[:, k0:k1])
    return dq.reshape(B, S, Hq, D), dk, dv


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, q_off=0,
                          kv_valid_len=None):
    """q: (B,Sq,Hq,Dqk); k: (B,Skv,Hkv,Dqk); v: (B,Skv,Hkv,Dv); query i of
    row b sits at position ``q_off[b] + i`` (``q_off`` an int or a (B,)
    int tensor), key j at position j; keys at or past ``kv_valid_len[b]``
    are masked.  ``scale`` defaults to 1/sqrt(Dqk).  Returns (B,Sq,Hq,Dv)
    in q's dtype."""
    B, Sq = q.shape[:2]
    q_pos = (torch.as_tensor(q_off, device=q.device).reshape(-1, 1)
             + torch.arange(Sq, device=q.device)).expand(B, Sq)
    return blocked_attention(q, k, v, q_pos,
                             torch.arange(k.shape[1], device=q.device),
                             window=window, causal=causal, scale=scale,
                             kv_valid_len=kv_valid_len)
