"""Shared layer primitives (port of ``repro/models/layers.py``).

Conventions
-----------
* ``init_*`` returns a dict of tensors; ``*_fwd`` applies it.  Repeated
  layers store their params stacked on a leading layer axis, as in JAX
  (the bridge then converts one-to-one); the model indexes layer ``i``.
* Params live in ``cfg.dtype`` (bf16 for production archs); softmax,
  norms and logits accumulate in fp32.
* Randomness comes from an explicit ``torch.Generator``.  The numbers
  differ from ``jax.random``'s for the same seed; the distributions do
  not.  Parity tests therefore init in JAX and convert (``bridge.py``).
* Each attention function keeps its JAX masking convention:
  ``blocked_attention`` uses ``-inf`` with isinf guards,
  ``masked_attention`` a plain softmax followed by NaN -> 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def group_norm(x, gamma, beta, n_groups: int, eps: float = 1e-5):
    """GroupNorm over the channel dim (RWKV6's wkv output), statistics in
    fp32: each of ``n_groups`` contiguous channel groups is normalised by
    its own mean and (biased) variance, then scaled and shifted."""
    *lead, c = x.shape
    x32 = x.float().reshape(*lead, n_groups, c // n_groups)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    x32 = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(*lead, c)
    return (x32 * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_sincos(positions, dim: int, theta: float):
    """positions: (...,) int -> sin/cos (..., dim/2) fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., n_heads, dim); sin/cos broadcastable (..., dim/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    sin = sin[..., None, :]          # broadcast over the heads axis
    cos = cos[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device),
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }


def mlp_fwd(p, x):
    g = F.silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# blocked (flash-style) full-sequence attention: online softmax over KV
# blocks, additionally blocked over Q (the JAX version rematerializes per
# Q block for the backward pass; the port runs inference only)
# ---------------------------------------------------------------------------


def blocked_attention(q, k, v, q_pos, kv_pos, *, window=0,
                      causal: bool = True, kv_block: int = 1024,
                      q_block: int = 512, scale: float | None = None,
                      kv_valid_len=None):
    """q: (B, Tq, Hq, D); k/v: (B, S, Hkv, D); q_pos: (B, Tq) absolute
    positions; kv_pos: (S,) absolute positions.  window: 0 => full; >0 =>
    sliding window (q attends kv iff q_pos - kv_pos < window), an int or a
    0-d int tensor.  kv_valid_len: (B,) masks kv entries >= len.
    Returns (B, Tq, Hq, D)."""
    Tq = q.shape[1]
    if Tq % q_block == 0 and Tq > q_block:
        return torch.cat([
            _blocked_attention_inner(
                q[:, i:i + q_block], k, v, q_pos[:, i:i + q_block], kv_pos,
                window=window, causal=causal, kv_block=kv_block, scale=scale,
                kv_valid_len=kv_valid_len)
            for i in range(0, Tq, q_block)], dim=1)
    return _blocked_attention_inner(q, k, v, q_pos, kv_pos, window=window,
                                    causal=causal, kv_block=kv_block,
                                    scale=scale, kv_valid_len=kv_valid_len)


def _blocked_attention_inner(q, k, v, q_pos, kv_pos, *, window, causal,
                             kv_block, scale, kv_valid_len):
    B, Tq, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if S % kv_block != 0:
        kv_block = S     # a single block for odd sizes, as in JAX
    kb = min(kv_block, S)

    qf = (q * scale).float().reshape(B, Tq, Hkv, G, D)
    w = torch.as_tensor(window, device=q.device)
    m = torch.full((B, Tq, Hkv, G), -math.inf, device=q.device)
    l = torch.zeros((B, Tq, Hkv, G), device=q.device)
    acc = torch.zeros((B, Tq, Hkv, G, Dv), device=q.device)
    for j0 in range(0, S, kb):
        kj = k[:, j0:j0 + kb].float()
        vj = v[:, j0:j0 + kb].float()
        pj = kv_pos[j0:j0 + kb]
        s = torch.einsum("bthgd,bshd->bthgs", qf, kj)
        mask = torch.ones((B, Tq, kb), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pj[None, None, :] <= q_pos[:, :, None]
        mask &= torch.where(w > 0, q_pos[:, :, None] - pj[None, None, :] < w,
                            True)
        if kv_valid_len is not None:
            mask &= pj[None, None, :] < kv_valid_len[:, None, None]
        mk = mask[:, :, None, None, :]
        s = torch.where(mk, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mk, p, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bthgs,bshd->bthgd", p, vj)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Tq, Hq, Dv).to(q.dtype)


def work_dtype(x) -> torch.dtype:
    """The type the plain attention versions compute in: fp32, or fp64
    for fp64 operands (a reference for the fp32 kernels on the card)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def masked_attention(q, k, v, mask, scale: float | None = None):
    """Small-T attention with an explicit mask (decode / dense verify).

    q: (B, T, Hq, D); k/v: (B, S, Hkv, D); mask: (B, T, S) bool.
    Computed in fp32 (fp64 for fp64 operands)."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    wt = work_dtype(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q * scale).to(wt).reshape(B, T, Hkv, G, D)
    s = torch.einsum("bthgd,bshd->bthgs", qf, k.to(wt))
    s = torch.where(mask[:, :, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bthgs,bshd->bthgd", p, v.to(wt))
    return out.reshape(B, T, Hq, Dv).to(q.dtype)
