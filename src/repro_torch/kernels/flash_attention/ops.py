"""Model-layout wrapper of the prefill attention kernel K3 (port of
``repro/kernels/flash_attention/ops.py::flash_attention_bshd``).

The wrapper validates what the kernel takes and dispatches on the device
the tensors lie on: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise, for every length (the kernel cuts a ragged
tail by its length; nothing is padded), ``meta`` tensors charge the cost
counter one call (``launch/op_cost.py``) and return an empty output
(under autograd too; the backward is then counted as the plain version's
ops, which is what it runs).  There is no fallback from one to
the other.  ``launches`` counts kernel launches, and only those;
``chunk_launches`` counts those of them that ran the chunk form (a call
with ``kv_valid_len``), ``grad_launches`` those made under autograd;
``f32_launches`` and ``f32_bwd_launches`` count the fp32 builds' launches
and backward calls, for a caller that resets them itself.  v
may have a head dim of its own (deepseek's MLA prefill: q/k 192, v 128):
each (Dqk, Dv) of ``kernel.DIMS`` has a build in bf16 and in fp32
(``kernel.F32_DIMS`` in fp32), and nothing is padded: other widths are
refused.

Two forms, one kernel: the whole prefill (q and k/v of one length, query
i at position i) and the chunk form of a resumable prefill (``q_off``:
the chunk's first position; ``kv_valid_len``: the keys written so far,
the cache view past it is masked and never read by the kernel).

A bf16 call runs the key tile ``resolve_key_tile`` gives: the autotuner's
winner for ``flash|dqk=..|dv=..|hq=..|hkv=..|causal=..``
(``kernels.tuned_block_sizes``), else the build's default (64).  The
heads enter the key because the best tile is the one that
fills the SMs, and the grid is query tiles times query heads.  A chunk
and the whole prefill of one layer resolve the same key, and a tile's
keys start at absolute multiples of the tile, so a chunk's rows keep the
whole prefill's bits.  The fp32 builds are not tuned: each has one key
tile (``kernel.F32_KEY_TILE``).

Under autograd (grad mode on and q, k or v requiring a gradient) a whole
prefill goes through ``FlashAttention``, a ``torch.autograd.Function``.
On CUDA its forward launches K3 as above, also writing each row's
log-sum-exp, and its backward launches the backward kernels
(``csrc/flash_attention_bwd.cu``: dQ, which also writes delta, then
dK/dV per query head and, with more query than kv heads or a split walk
(``kernel.py::bwd_split``), the partials' sum, in bf16 and in fp32) on
the saved q/k/v, output and log-sum-exp; ``bwd_launches`` counts its
calls, each of which launches each of those kernels once.  On the CPU
the backward recomputes the plain version (``models/layers.py::
blocked_attention``, the port of the jnp function JAX's trainer
differentiates, recomputed as ``jax.checkpoint`` recomputes it) and
returns its gradients.  JAX has no backward kernel.  The chunk form has
no backward and raises under autograd, as every other kernel wrapper
without one does (``kernels.refuse_grad``).
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch

from repro_torch.kernels import refuse_grad, tuned_block_sizes
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.launch.op_cost import (chunk_rows, dtype_name,
                                        flash_bwd_charge, flash_charge,
                                        k3_pairs, record_kernel)

launches = 0                  # kernel launches since the last reset
chunk_launches = 0            # of which with a query offset / kv_valid_len
grad_launches = 0             # of which under autograd (FlashAttention)
bwd_launches = 0              # backward calls (FlashAttention)
f32_launches = 0              # launches of an fp32 build (not reset by
f32_bwd_launches = 0          # kernels.reset_counts), and fp32 backward calls


def _check(q, k, v, chunk: bool):
    B, S, Hq, D = q.shape
    Skv = k.shape[1] if chunk and k.dim() == 4 else S
    if k.dim() != 4 or k.shape[:2] != (B, Skv) or k.shape[3] != D \
            or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k/v must be (B, S, Hkv, D) = ({B}, {Skv}, Hkv, "
                         f"{D}) and (B, S, Hkv, Dv), got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if Hq % k.shape[2] != 0:
        raise ValueError(f"{Hq} query heads do not group over {k.shape[2]} "
                         "kv heads")


def _row_ints(x, B: int, device, what: str):
    """``x`` (an int, or a (B,) integer tensor on ``device``) as (B,)
    int32 on ``device``."""
    if isinstance(x, int):
        return torch.full((B,), x, dtype=torch.int32, device=device)
    if x.shape != (B,) or x.dtype.is_floating_point or x.device != device:
        raise ValueError(f"{what} must be an int or a ({B},) integer tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    return x.to(torch.int32).contiguous()


def _check_cuda(q, k, v):
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _k.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands only")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel reads 16 bytes a thread: q, k and v "
                         "must start on a 16-byte boundary")
    if q.dtype == torch.bfloat16:   # the bf16 body loads through TMA
        for name, t in (("q", q), ("k", k), ("v", v)):
            _k.check_tma(name, t.shape, t.stride(), t.data_ptr(),
                         t.element_size())
    dims = (q.shape[-1], v.shape[-1])
    builds = _k.F32_DIMS if q.dtype == torch.float32 else _k.DIMS
    if dims not in builds:
        raise ValueError(f"head dims (q/k, v) {dims} not among the {q.dtype} "
                         f"builds {builds}")


def tuning_shape(dqk: int, dv: int, Hq: int, Hkv: int,
                 causal: bool) -> dict:
    """The cache key's shape of a bf16 call: the build (Dqk, Dv), the
    heads and the mask (the window stays out: one layer stack's local and
    global layers share a key)."""
    return {"dqk": dqk, "dv": dv, "hq": Hq, "hkv": Hkv,
            "causal": int(causal)}


@lru_cache(maxsize=None)
def resolve_key_tile(dqk: int, dv: int, Hq: int, Hkv: int,
                     causal: bool) -> int:
    """The bf16 (Dqk, Dv) build's key tile at these heads: the cache's
    winner, else ``DEFAULT_KEY_TILE``.  Resolved once a process per shape
    (under the mode and cache in force at its first call), so an eager
    call pays for the lookup once."""
    return tuned_block_sizes(
        "flash", tuning_shape(dqk, dv, Hq, Hkv, causal),
        defaults={"key_tile": _k.DEFAULT_KEY_TILE[(dqk, dv)]})["key_tile"]


def check_key_tile(dqk: int, dv: int, key_tile: int) -> None:
    if key_tile not in _k.KEY_TILES[(dqk, dv)]:
        raise ValueError(f"key tile {key_tile} not among the ({dqk}, {dv}) "
                         f"build's {_k.KEY_TILES[(dqk, dv)]}")


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None, q_off=0,
                         kv_valid_len=None, key_tile: int | None = None):
    """q: (B,Sq,Hq,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv), the model
    layout.  Whole prefill (``kv_valid_len`` None): Skv = Sq, query and
    key i sit at position i.  Chunk form (``kv_valid_len`` (B,) given):
    query i of row b sits at position ``q_off[b] + i`` (``q_off`` an int
    or a (B,) integer tensor), key j of the cache view at position j, and
    keys at or past ``kv_valid_len[b]`` are masked (never read by the
    kernel); a chunk whose first position is a multiple of 64 (the query
    tile, in bf16 and fp32) gives its rows the whole prefill's bits.  ``window`` (int) > 0
    admits keys less than ``window`` positions back.  ``scale`` multiplies
    the scores (default 1/sqrt(D); MLA's prefill passes 1/sqrt(nd + rd)).
    ``key_tile`` forces a bf16 call's key tile (default:
    ``resolve_key_tile``'s; an fp32 build has one).  Returns
    (B,Sq,Hq,Dv) in q's dtype."""
    chunk = kv_valid_len is not None
    if not chunk and not (isinstance(q_off, int) and q_off == 0):
        raise ValueError("a query offset needs kv_valid_len (the chunk form)")
    _check(q, k, v, chunk)
    window = int(window)
    B = q.shape[0]
    if chunk:
        refuse_grad("flash_attention (chunk form)", q, k, v)
        q_off = _row_ints(q_off, B, q.device, "q_off")
        kv_valid_len = _row_ints(kv_valid_len, B, q.device, "kv_valid_len")
    elif torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale, key_tile)
    return _forward(q, k, v, causal=causal, window=window, scale=scale,
                    q_off=q_off, kv_valid_len=kv_valid_len,
                    key_tile=key_tile)


def _forward(q, k, v, *, causal: bool, window: int, scale, q_off=0,
             kv_valid_len=None, key_tile: int | None = None, lse=None):
    """The plain version on the CPU, the kernel on CUDA (validated, counted);
    operands already checked by the wrapper.  ``lse`` ((B, Hq, Sq) fp32,
    CUDA only): where the kernel writes each row's log-sum-exp."""
    global launches, chunk_launches, f32_launches
    chunk = kv_valid_len is not None
    if q.device.type == "cpu":
        return _k.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        scale=scale, q_off=q_off,
                                        kv_valid_len=kv_valid_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no flash_attention for device {q.device}")
    _check_cuda(q, k, v)
    if q.device.type == "meta":
        _record_meta_call(q, k, v, causal, window, chunk)
        return q.new_empty((*q.shape[:3], v.shape[-1]))
    dqk, dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(dqk)
    if q.dtype == torch.bfloat16:
        if key_tile is None:
            key_tile = resolve_key_tile(dqk, dv, q.shape[2], k.shape[2],
                                        causal)
        check_key_tile(dqk, dv, key_tile)
    out = q.new_empty((*q.shape[:3], dv))
    rc = _k.launch(q, k, v, out, causal=causal, window=window, scale=scale,
                   q_off=q_off if chunk else None, kv_valid_len=kv_valid_len,
                   key_tile=key_tile or 0, lse=lse)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    launches += 1
    chunk_launches += chunk
    f32_launches += q.dtype == torch.float32
    return out


def _record_meta_call(q, k, v, causal: bool, window: int,
                      chunk: bool) -> None:
    """Charge a call on ``meta``: a whole prefill's admitted pairs, or a
    chunk at capacity (its rows at the end of the key view)."""
    B, Sq, Hq, dqk = q.shape
    Skv = k.shape[1]
    if chunk:
        pairs, keys = chunk_rows(Skv - Sq, Sq, window)
    else:
        pairs, keys = k3_pairs(Sq, window, causal), Sq
    shape = dict(B=B, Sq=Sq, keys=keys, Hq=Hq, Hkv=k.shape[2], dqk=dqk,
                 dv=v.shape[-1], dtype=dtype_name(q.dtype), pairs=pairs)
    record_kernel("flash_attention", flash_charge(**shape), chunk=chunk,
                  window=window, causal=causal, **shape)


def _backward(q, k, v, out, lse, grad_out, *, causal: bool, window: int,
              scale):
    """The backward kernels on CUDA (counted), one charged call on
    ``meta``: (dq, dk, dv)."""
    global bwd_launches, f32_bwd_launches
    B, S, Hq, dqk = q.shape
    dv_ = v.shape[-1]
    do = grad_out.to(q.dtype).contiguous()
    if q.device.type == "meta":
        # the scratch the launch allocates
        _k.bwd_scratch(B, S, Hq, k.shape[2], dqk, dv_, q.dtype, q.device)
        shape = dict(B=B, S=S, Hq=Hq, Hkv=k.shape[2], dqk=dqk, dv=dv_,
                     dtype=dtype_name(q.dtype),
                     pairs=k3_pairs(S, window, causal))
        record_kernel("flash_attention_bwd", flash_bwd_charge(**shape),
                      window=window, causal=causal, **shape)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if scale is None:
        scale = 1.0 / math.sqrt(dqk)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    rc = _k.launch_bwd(q, k, v, out, lse, do, *grads, causal=causal,
                       window=window, scale=scale)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention backward launch failed: CUDA error {rc}")
    bwd_launches += 1
    f32_bwd_launches += q.dtype == torch.float32
    return grads


class FlashAttention(torch.autograd.Function):
    """K3's whole prefill with a gradient.  CUDA: the forward launches the
    kernel, which also writes each row's log-sum-exp, and the backward
    launches the backward kernels (``_backward``).  CPU: the forward runs
    the plain version and the backward recomputes it on the saved q/k/v
    and differentiates it.  The forward runs the key tile a call without
    autograd resolves."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale, key_tile):
        global grad_launches
        lse = None
        if q.device.type != "cpu":
            lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                              dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, causal=causal, window=window, scale=scale,
                       key_tile=key_tile, lse=lse)
        grad_launches += q.device.type == "cuda"
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        causal, window, scale = ctx.attrs
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type != "cpu":
            grads = _backward(q, k, v, out, lse, grad_out, causal=causal,
                              window=window, scale=scale)
            return (*(g if need else None for g, need in
                      zip(grads, ctx.needs_input_grad[:3])),
                    None, None, None, None)
        saved = [t.detach().requires_grad_(need) for t, need in
                 zip((q, k, v), ctx.needs_input_grad[:3])]
        wanted = [t for t in saved if t.requires_grad]
        with torch.enable_grad():
            out = _k.flash_attention_plain(*saved, causal=causal,
                                           window=window, scale=scale)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in saved),
                None, None, None, None)
