"""RWKV6 'Finch' layers (port of the RWKV6 half of
``repro/models/ssm.py``): time-mix over a decay linear attention, and
channel-mix.

The time-mix reduces to *decay linear attention*, per head:

    S_t = Diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t = log-decay <= 0)
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t         (u: per-head bonus)

with a per-token, per-channel decay ``w_t``.  Two execution paths share
the math:

* full mode (prefill): the chunked scan, through the wrapper of the
  hand-written kernel K6 (``kernels/linear_attn_chunk``), which takes the
  initial state and returns the final one;
* verify mode: ``decay_attention_seq``, the per-token scan that returns
  EVERY intermediate state, so a chain-speculative verify can roll back to
  the last accepted token by selecting a candidate (``serving/cache.py``).
  It stays plain PyTorch: no TPU kernel computes it.

Mamba2 (the scalar-decay SSD) is not ported yet (ROADMAP).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_attn_chunk.ops import linear_attn_bshd
from repro_torch.models.layers import dense_init, group_norm

RWKV_LORA = 32
RWKV_LORA_W = 64
GN_EPS = 64e-5          # RWKV6's GroupNorm epsilon on the wkv output


def _pad_mask(valid_len, T: int):
    """(B, T) bool: position < valid_len.  None => all valid."""
    if valid_len is None:
        return None
    return (torch.arange(T, device=valid_len.device)[None, :]
            < valid_len[:, None])


def _mask_decay_inputs(mask, w_log, k):
    """Length-masked scan: force log-decay 0 (decay 1) and key 0 at
    right-pad positions, so the recurrent state is carried past pads
    unchanged, the same rule the chunked scan uses for its own padding to
    a chunk multiple.  w_log, k: (B, T, H, d)."""
    if mask is None:
        return w_log, k
    m = mask[:, :, None, None]
    return torch.where(m, w_log, 0.0), torch.where(m, k, 0.0)


def _gather_last_valid(x, valid_len):
    """x: (B, T, ...) -> (B, 1, ...) at per-row index valid_len - 1
    (plain ``x[:, -1:]`` when valid_len is None)."""
    if valid_len is None:
        return x[:, -1:]
    idx = torch.clamp(valid_len.long() - 1, 0, x.shape[1] - 1)
    idx = idx.reshape((-1,) + (1,) * (x.ndim - 1)).expand(
        (-1, 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


# ---------------------------------------------------------------------------
# the per-token scan (verify)
# ---------------------------------------------------------------------------


def decay_attention_seq(r, k, v, w_log, u=None, initial_state=None):
    """Per-token scan with the RWKV6 readout o_t = r_t S_{t-1} +
    (r_t.(u*k_t)) v_t.  r/k/w_log: (B,T,H,dk); v: (B,T,H,dv); u: (H,dk)
    or None; initial_state: (B,H,dk,dv) or None (zeros).

    Returns (o (B,T,H,dv) in v's dtype, states (B,T,H,dk,dv) fp32): the
    state after each token."""
    B, T, H, dk = k.shape
    dv = v.shape[-1]
    if initial_state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                            device=k.device)
    else:
        state = initial_state.float()
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w_log))
    uf = u.float()[None] if u is not None else None
    outs, states = [], []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]   # (B,H,d*)
        o = torch.einsum("bhd,bhdv->bhv", rt, state)
        if uf is not None:
            o = o + torch.einsum("bhd,bhd->bh", rt * uf, kt)[..., None] * vt
        state = state * torch.exp(wt)[..., None] + \
            kt[..., None] * vt[:, :, None]
        outs.append(o)
        states.append(state)
    o = torch.stack(outs, dim=1).to(v.dtype)
    return o, torch.stack(states, dim=1)


# ---------------------------------------------------------------------------
# RWKV6 layer (time-mix + channel-mix)
# ---------------------------------------------------------------------------


def init_rwkv6(gen, cfg, dtype, device):
    """Random RWKV6 layer params with the JAX init's distributions; the
    decay base, the bonus and the GroupNorm affine are fp32 as in JAX."""
    d, dff = cfg.d_model, cfg.d_ff
    H = cfg.n_heads
    hd = d // H
    f32 = dict(dtype=torch.float32, device=device)
    lin = lambda a, b: dense_init(gen, a, b, dtype, device)
    small = lambda *s: (torch.randn(s, generator=gen, **f32) * 0.01).to(dtype)
    return {
        # time-mix ddlerp: mu_x + per-target mus + lora (5 targets: w,k,v,r,g)
        "tm_mu_x": torch.zeros((d,), dtype=dtype, device=device),
        "tm_mu": torch.zeros((5, d), dtype=dtype, device=device),
        "tm_lora_a": lin(d, 5 * RWKV_LORA),
        "tm_lora_b": small(5, RWKV_LORA, d),
        # decay
        "w0": torch.full((d,), -1.0, **f32),
        "w_lora_a": lin(d, RWKV_LORA_W),
        "w_lora_b": small(RWKV_LORA_W, d),
        "u_bonus": torch.zeros((H, hd), **f32),
        "wr": lin(d, d), "wk": lin(d, d), "wv": lin(d, d),
        "wg": lin(d, d), "wo": lin(d, d),
        "gn_gamma": torch.ones((d,), **f32),
        "gn_beta": torch.zeros((d,), **f32),
        # channel-mix
        "cm_mu_k": torch.zeros((d,), dtype=dtype, device=device),
        "cm_mu_r": torch.zeros((d,), dtype=dtype, device=device),
        "cm_wk": lin(d, dff), "cm_wv": lin(dff, d),
        "cm_wr": lin(d, d),
    }


def _token_shift(x, last):
    """last: (B,1,d) previous token (zeros at sequence start)."""
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv6_timemix(p, cfg, x, *, mode: str, wkv_state=None, shift_last=None,
                  chunk: int = 64, valid_len=None):
    """x: (B,T,d).  Returns (out (B,T,d), new states):

    full:   {"wkv_state": (B,H,dk,dv) final, "shift_tm": (B,1,d)}; the
            chunked scan runs through K6's wrapper.  ``valid_len`` (B,)
            length-masks the scan past right-pads and takes the shift
            state at ``valid_len - 1``;
    verify: {"wkv_state": (B,T,H,dk,dv), "shift_tm": (B,T,1,d)}, the
            per-token candidates (the singleton axis kept, so selecting
            one along T gives the committed layout)."""
    B, T, d = x.shape
    H = cfg.n_heads
    hd = d // H
    if shift_last is None:
        shift_last = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    xx = _token_shift(x, shift_last) - x

    z = x + xx * p["tm_mu_x"]
    lora = torch.tanh(z @ p["tm_lora_a"]).reshape(B, T, 5, RWKV_LORA)
    mix = p["tm_mu"][None, None] + torch.einsum(
        "btfr,frd->btfd", lora, p["tm_lora_b"].to(x.dtype))
    xw, xk, xv, xr, xg = [x + xx * mix[:, :, i] for i in range(5)]

    # the decay in fp32 from the activations and weights, as JAX has it
    w_log = -torch.exp(p["w0"] + torch.tanh(
        xw.float() @ p["w_lora_a"].float()) @ p["w_lora_b"].float())
    r = (xr @ p["wr"]).reshape(B, T, H, hd)
    k = (xk @ p["wk"]).reshape(B, T, H, hd)
    v = (xv @ p["wv"]).reshape(B, T, H, hd)
    g = xg @ p["wg"]
    w_log = w_log.reshape(B, T, H, hd)

    if mode == "full":
        w_m, k_m = _mask_decay_inputs(_pad_mask(valid_len, T), w_log, k)
        o, final_state = linear_attn_bshd(r, k_m, v, w_m, p["u_bonus"],
                                          wkv_state, chunk=chunk)
        new = {"wkv_state": final_state,
               "shift_tm": _gather_last_valid(x, valid_len)}
    elif mode == "verify":
        o, states = decay_attention_seq(r, k, v, w_log, u=p["u_bonus"],
                                        initial_state=wkv_state)
        new = {"wkv_state": states, "shift_tm": x[:, :, None, :]}
    else:
        raise ValueError(f"mode must be 'full' or 'verify': {mode}")
    o = group_norm(o.reshape(B, T, d), p["gn_gamma"], p["gn_beta"], H,
                   eps=GN_EPS)
    return (o * F.silu(g)) @ p["wo"], new


def rwkv6_chanmix(p, x, *, shift_last=None):
    B, T, d = x.shape
    if shift_last is None:
        shift_last = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    xx = _token_shift(x, shift_last) - x
    xk = x + xx * p["cm_mu_k"]
    xr = x + xx * p["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])
