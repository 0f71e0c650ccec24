"""Model-layout wrapper of the prefill attention kernel K3 (port of
``repro/kernels/flash_attention/ops.py::flash_attention_bshd``).

The wrapper validates what the kernel takes and dispatches on the device
the tensors lie on: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise, for every S (the kernel cuts a ragged tail by
its length; nothing is padded).  There is no fallback from one to the
other.  ``launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _k

launches = 0                  # kernel launches since the last reset


def _check(q, k, v):
    B, S, Hq, D = q.shape
    if k.dim() != 4 or k.shape[:2] != (B, S) or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, S, Hkv, D) = ({B}, {S}, Hkv, {D}),"
                         f" got {tuple(k.shape)} / {tuple(v.shape)}")
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
    D = q.shape[-1]
    if D not in _k.MAX_ROWS:
        raise ValueError(f"head dim {D} not in {_k.HEAD_DIMS}")
    G = q.shape[2] // k.shape[2]
    if G > _k.MAX_ROWS[D]:
        raise ValueError(f"{G} query heads per kv head exceed the kernel's "
                         f"{_k.MAX_ROWS[D]} rows at head dim {D}")


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None):
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D), the model layout; query and key i
    sit at position i (the sequence starts at 0, or at any offset: the
    masks depend only on position differences).  ``window`` (int) > 0
    admits keys less than ``window`` positions back.  ``scale`` multiplies
    the scores (default 1/sqrt(D); MLA's prefill passes 1/sqrt(nd + rd)
    for q/k zero-padded to a head dim the kernel takes).  Returns
    (B,S,Hq,D) in q's dtype."""
    global launches
    _check(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return _k.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    rc = _k.launch(q, k, v, out, causal=causal, window=window, scale=scale)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    launches += 1
    return out
