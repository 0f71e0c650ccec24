"""Model-layout wrapper of the prefill attention kernel K3 (port of
``repro/kernels/flash_attention/ops.py::flash_attention_bshd``).

The wrapper validates what the kernel takes and dispatches on the device
the tensors lie on: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise, for every S (the kernel cuts a ragged tail by
its length; nothing is padded).  There is no fallback from one to the
other.  ``launches`` counts kernel launches, and only those.  v may have a
head dim of its own (deepseek's MLA prefill: q/k 192, v 128) where a bf16
build takes it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as _k

launches = 0                  # kernel launches since the last reset


def _check(q, k, v):
    B, S, Hq, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != D \
            or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k/v must be (B, S, Hkv, D) = ({B}, {S}, Hkv, {D})"
                         f" and (B, S, Hkv, Dv), got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if Hq % k.shape[2] != 0:
        raise ValueError(f"{Hq} query heads do not group over {k.shape[2]} "
                         "kv heads")


def _check_cuda(q, k, v):
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _k.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands only")
    dims = (q.shape[-1], v.shape[-1])
    if q.dtype == torch.bfloat16:
        if dims not in _k.BF16_DIMS:
            raise ValueError(f"head dims (q/k, v) {dims} not in "
                             f"{_k.BF16_DIMS}")
        return
    D = _f32_dim(*dims)
    if D is None:
        raise ValueError(f"head dims {dims} exceed {max(_k.HEAD_DIMS)}")
    G = q.shape[2] // k.shape[2]
    if G > _k.MAX_ROWS[D]:
        raise ValueError(f"{G} query heads per kv head exceed the kernel's "
                         f"{_k.MAX_ROWS[D]} rows at head dim {D}")


def _f32_dim(dqk: int, dv: int):
    """The fp32 build's head dim for (dqk, dv): the least that holds both
    (the fp32 body takes one head dim for q/k and v), or None."""
    return min((d for d in _k.HEAD_DIMS if d >= max(dqk, dv)), default=None)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None):
    """q: (B,S,Hq,D); k: (B,S,Hkv,D); v: (B,S,Hkv,Dv), the model layout;
    query and key i sit at position i (the sequence starts at 0, or at any
    offset: the masks depend only on position differences).  ``window``
    (int) > 0 admits keys less than ``window`` positions back.  ``scale``
    multiplies the scores (default 1/sqrt(D); MLA's prefill passes
    1/sqrt(nd + rd)).  Returns (B,S,Hq,Dv) in q's dtype."""
    global launches
    _check(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return _k.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check_cuda(q, k, v)
    dqk, dv = q.shape[-1], v.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(dqk)
    if q.dtype == torch.float32 and dqk != dv:
        # the fp32 body takes one head dim: for fp32 alone, q/k and v are
        # zero-padded to it (zero columns add exact zeros to every score
        # and leave the padded output columns at zero) and the output is
        # sliced back; bf16 runs the (dqk, dv) build unpadded
        D = _f32_dim(dqk, dv)
        q, k, v = (F.pad(t, (0, D - t.shape[-1])) for t in (q, k, v))
    out = q.new_empty((*q.shape[:3], v.shape[-1]))
    rc = _k.launch(q, k, v, out, causal=causal, window=window, scale=scale)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    launches += 1
    return out[..., :dv] if out.shape[-1] != dv else out
