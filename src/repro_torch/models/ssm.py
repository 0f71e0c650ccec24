"""SSM layers (port of ``repro/models/ssm.py``): RWKV6 'Finch' (time-mix
over a decay linear attention, and channel-mix) and Mamba2 (the SSD).

Both reduce to *decay linear attention*, per head:

    S_t = Diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t = log-decay <= 0)
    o_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t         (u: per-head bonus)

RWKV6 has a per-token, per-channel decay ``w_t`` and the readout above.
Mamba2 has one decay per head and token, ``a_t = exp(dt_t * A_h)``, keys
``B`` and queries ``C`` shared by every head (one group), and the
post-update readout ``o_t = C_t . S_t``.  Two execution paths each:

* full mode (prefill, and training): RWKV6's chunked scan through the
  wrapper of the hand-written kernel K6 (``kernels/linear_attn_chunk``),
  which takes the initial state and returns the final one, and under
  autograd goes through K6's ``LinearAttnChunk`` (on the card the
  backward launches K6's backward kernels; on the CPU it differentiates
  the plain version); Mamba2's grouped SSD (``mamba2_ssd_chunked``),
  which computes the (c, c) score matrix once per group and never
  broadcasts B and C across heads.  No TPU kernel computes the SSD (JAX
  runs it in jnp), so it is plain PyTorch, and autograd differentiates
  it and the causal conv directly (neither writes in place);
* verify mode: ``decay_attention_seq``, the per-token scan that returns
  EVERY intermediate state, so a chain-speculative verify can roll back to
  the last accepted token by selecting a candidate (``serving/cache.py``).
  It stays plain PyTorch: no TPU kernel computes it.

Mamba2's causal depthwise conv carries a window of the last
``conv_width - 1`` inputs (``conv_win``) as a second recurrent state; the
verify mode returns it after every token too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_attn_chunk.ops import linear_attn_bshd
from repro_torch.models.layers import dense_init, group_norm, rms_norm

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
    unchanged, the same rule the chunked scans use for their own padding
    to a chunk multiple.  w_log, k: (B, T, ...) of any rank: RWKV6's
    (B, T, H, d), Mamba2's (B, T, H) decay and (B, T, ds) keys."""
    if mask is None:
        return w_log, k
    over = lambda t: mask.reshape(mask.shape + (1,) * (t.ndim - 2))
    return torch.where(over(w_log), w_log, 0.0), torch.where(over(k), k, 0.0)


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


def decay_attention_seq(r, k, v, w_log, u=None, initial_state=None,
                        readout: str = "pre"):
    """Per-token scan.  r/k: (B,T,H,dk); v: (B,T,H,dv); w_log:
    (B,T,H,dk), or (B,T,H,1) for a scalar decay per head (Mamba2); u:
    (H,dk) or None; initial_state: (B,H,dk,dv) or None (zeros).

    readout='pre'  (RWKV6): o_t = r_t S_{t-1} + (r_t.(u*k_t)) v_t
    readout='post' (Mamba2): o_t = r_t S_t  (state inclusive of token t)

    r and k may be broadcast views (``expand``) of Mamba2's group-shared
    C and B: nothing here writes or copies them whole.  Returns (o
    (B,T,H,dv) in v's dtype, states (B,T,H,dk,dv) fp32): the state after
    each token."""
    if readout not in ("pre", "post"):
        raise ValueError(f"readout must be 'pre' or 'post': {readout}")
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
        if readout == "pre":
            o = torch.einsum("bhd,bhdv->bhv", rt, state)
            if uf is not None:
                o = o + torch.einsum("bhd,bhd->bh", rt * uf,
                                     kt)[..., None] * vt
        state = state * torch.exp(wt)[..., None] + \
            kt[..., None] * vt[:, :, None]
        if readout == "post":
            o = torch.einsum("bhd,bhdv->bhv", rt, state)
        outs.append(o)
        states.append(state)
    o = torch.stack(outs, dim=1).to(v.dtype)
    return o, torch.stack(states, dim=1)


# ---------------------------------------------------------------------------
# Mamba2's grouped SSD (the prefill scan)
# ---------------------------------------------------------------------------


def mamba2_ssd_chunked(r, k, v, w_log, initial_state=None, chunk: int = 64):
    """Grouped SSD chunked scan (Mamba2's full-mode path).

    r/k: (B, S, ds), C and B, shared across heads (one group); v: (B, S,
    H, hd); w_log: (B, S, H), the per-head scalar log-decay (<= 0).  The
    readout is o_t = C_t . h_t with h_t = a_t h_{t-1} + B_t v_t^T (state
    INCLUSIVE of token t, so the intra-chunk mask keeps the diagonal).
    The (c, c) score matrix C B^T is computed once per group, and B and C
    are never broadcast across the head axis.  A tail short of a chunk is
    padded with k = v = 0 and w = 0 (decay 1), which leaves the state
    exact.  Returns (o (B, S, H, hd) in v's dtype, final_state (B, H, ds,
    hd) fp32)."""
    B, S, ds = k.shape
    H, hd = v.shape[2], v.shape[3]
    S_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        r = F.pad(r, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        w_log = F.pad(w_log, (0, 0, 0, pad))
        S += pad
    nc = S // chunk
    rf = r.float().reshape(B, nc, chunk, ds)
    kf = k.float().reshape(B, nc, chunk, ds)
    vf = v.float().reshape(B, nc, chunk, H, hd)
    wf = w_log.float().reshape(B, nc, chunk, H)
    if initial_state is None:
        state = torch.zeros((B, H, ds, hd), dtype=torch.float32,
                            device=k.device)
    else:
        state = initial_state.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=k.device).tril()                # INCLUSIVE diag
    outs = []
    for c in range(nc):
        rc, kc, vc, wc = rf[:, c], kf[:, c], vf[:, c], wf[:, c]
        lcw = torch.cumsum(wc, dim=1)                       # (B,c,H) inclusive
        a0 = torch.einsum("btd,bsd->bts", rc, kc)           # group-shared
        e = torch.exp(torch.clamp_max(lcw[:, :, None] - lcw[:, None], 0.0))
        e = torch.where(tri[None, :, :, None], e, 0.0)      # (B,t,s,H)
        o = torch.einsum("btsh,bshv->bthv", a0[..., None] * e, vc)
        # inter-chunk: o_t += exp(lcw_t) * (C_t . S0)
        rs = torch.einsum("btd,bhdv->bthv", rc, state)
        o = o + torch.exp(lcw)[..., None] * rs
        # state update
        lcw_c = lcw[:, -1:]                                 # (B,1,H)
        dec = torch.exp(lcw_c - lcw)                        # (B,c,H)
        state = state * torch.exp(lcw_c[:, 0])[..., None, None] + \
            torch.einsum("bsd,bshv->bhdv", kc, dec[..., None] * vc)
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :S_orig]
    return o.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 (SSD) layer
# ---------------------------------------------------------------------------


def mamba2_dims(cfg):
    """(d_in, SSD heads, conv channels) of a Mamba2 layer."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return d_in, n_heads, conv_ch


def init_mamba2(gen, cfg, dtype, device):
    """Random Mamba2 layer params with the JAX init's distributions;
    ``a_log``, ``d_skip`` and ``dt_bias`` are fp32 as in JAX."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, conv_ch = mamba2_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, d, 2 * d_in + 2 * s.d_state + H, dtype,
                           device),
        "conv_w": (torch.randn((s.conv_width, conv_ch), generator=gen, **f32)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((H,), **f32),                  # A = -exp(a_log)
        "d_skip": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), math.log(math.e - 1), **f32),
        "norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_in, d, dtype, device),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv.  x: (B,T,C); w: (W,C); b: (C,); conv_state:
    (B,W-1,C), the inputs before x (zeros when None).

    Returns (y (B,T,C) in x's dtype, from fp32 products, and windows
    (B,T,W-1,C)), where windows[:, t] is the conv state AFTER consuming
    token t (the last W-1 inputs ending at t): a view, not a copy."""
    W = w.shape[0]
    B, T, C = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, C), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)     # (B, T+W-1, C)
    wf = w.float()
    y = xp[:, 0:T].float() * wf[0]
    for j in range(1, W):
        y = y + xp[:, j:j + T].float() * wf[j]
    y = y + b.float()
    windows = xp.unfold(1, W - 1, 1)[:, 1:].transpose(2, 3)  # (B,T,W-1,C)
    return y.to(x.dtype), windows


def mamba2_fwd(p, cfg, x, *, mode: str, ssd_state=None, conv_state=None,
               valid_len=None):
    """x: (B,T,d).  Returns (out (B,T,d), new states):

    full:   {"ssd_state": (B,H,ds,hd) final, "conv_win": (B,W-1,C)
            final}, through the grouped SSD.  ``valid_len`` (B,)
            length-masks the scan past right-pads (decay 1, key 0: the
            state is carried past them unchanged) and takes the conv
            window after token ``valid_len - 1``;
    verify: {"ssd_state": (B,T,H,ds,hd), "conv_win": (B,T,W-1,C)}, the
            per-token candidates (post-update readout).

    The dtype steps are JAX's: the conv output back in the model dtype,
    then silu; ``dt`` through softplus in fp32; v and ``y + d_skip * xs``
    in fp32; then the gated RMSNorm in the model dtype."""
    s = cfg.ssm
    d_in, H, conv_ch = mamba2_dims(cfg)
    B, T, _ = x.shape
    hd, ds = s.head_dim, s.d_state

    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_ch]
    dt_raw = zxbcdt[..., d_in + conv_ch:]

    xbc, windows = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(B, T, H, hd)
    b_mat = xbc[..., d_in:d_in + ds]                        # (B,T,ds) group=1
    c_mat = xbc[..., d_in + ds:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                              # (H,) negative
    w_scalar = dt * a                                       # (B,T,H) <= 0
    v = xs.float() * dt[..., None]                          # (B,T,H,hd)

    if mode == "full":
        w_m, b_m = _mask_decay_inputs(_pad_mask(valid_len, T), w_scalar,
                                      b_mat.float())
        o, final_state = mamba2_ssd_chunked(c_mat.float(), b_m, v, w_m,
                                            initial_state=ssd_state,
                                            chunk=s.chunk_size)
        new = {"ssd_state": final_state,
               "conv_win": _gather_last_valid(windows, valid_len)[:, 0]}
    elif mode == "verify":
        # B and C broadcast over the heads as views (no copy)
        k = b_mat.float()[:, :, None, :].expand(B, T, H, ds)
        r = c_mat.float()[:, :, None, :].expand(B, T, H, ds)
        o, states = decay_attention_seq(r, k, v, w_scalar[..., None],
                                        initial_state=ssd_state,
                                        readout="post")
        new = {"ssd_state": states, "conv_win": windows}
    else:
        raise ValueError(f"mode must be 'full' or 'verify': {mode}")

    y = o.float() + p["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(B, T, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.rms_eps)
    return y @ p["w_out"], new


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
