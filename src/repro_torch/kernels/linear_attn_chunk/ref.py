"""Chunked decay linear attention (K6): the plain PyTorch versions of the
Hopper kernel.

* ``decay_attention_chunked`` is a torch port of
  ``repro/models/ssm.py::decay_attention_chunked`` (per-channel decay,
  RWKV6's form): chunks of ``chunk`` tokens, strict-lower pairwise-decay
  scores ``exp(min(lcw_excl[t] - lcw[s], 0))`` (no exponent is positive,
  whatever the decay), the u-bonus diagonal, the inter-chunk term of a
  carried fp32 state, an optional initial state and the final state.  The
  wrapper takes it for CPU tensors, and ``chip_smoke.py`` holds the kernel
  against it on the card.
* ``decay_attention_chunk_parallel`` repeats the CUDA kernel's own
  decomposition: every chunk's intra-chunk part at once, its scores built
  from secondary chunks (pairwise diagonal blocks, off-diagonal blocks
  factored through the end of the earlier sub-chunk), then a scan of the
  state across chunks.  The CPU tests hold it against the other forms and
  JAX; nothing on the main path runs it.
* ``linear_attn_ref`` is the sequential recurrence, a torch port of
  ``repro/kernels/linear_attn_chunk/ref.py::linear_attn_ref`` in its
  kernel layout ``(B, H, S, d)``; the tests keep it as an oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def decay_attention_chunked(r, k, v, w_log, u=None, initial_state=None,
                            chunk: int = 64):
    """r/k/w_log: (B,S,H,dk); v: (B,S,H,dv); u: (H,dk) or None;
    initial_state: (B,H,dk,dv) or None (zeros).

    Returns (o (B,S,H,dv) in v's dtype, final_state (B,H,dk,dv) fp32).
    S is padded to a chunk multiple with k = 0 and w_log = 0 (decay 1,
    nothing added): exact."""
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    S_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        r, k, v, w_log = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, w_log))
        S += pad
    nc = S // chunk
    rf, kf, vf, wf = (t.float().reshape(B, nc, chunk, H, t.shape[-1])
                      for t in (r, k, v, w_log))
    if initial_state is None:
        state = torch.zeros((B, H, dk, dv), dtype=torch.float32,
                            device=k.device)
    else:
        state = initial_state.float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=k.device).tril(-1)                 # strict lower
    uf = u.float()[None, None] if u is not None else None
    outs = []
    for c in range(nc):
        rc, kc, vc, wc = rf[:, c], kf[:, c], vf[:, c], wf[:, c]  # (B,c,H,d*)
        lcw = torch.cumsum(wc, dim=1)                            # inclusive
        lcw_excl = lcw - wc
        q_eff = rc * torch.exp(lcw_excl)
        # E[t,s,h,d] = exp(lcw_excl[t,d] - lcw[s,d]), pairwise so that no
        # exponent is positive (a factorised form overflows)
        dlt = lcw_excl[:, :, None] - lcw[:, None]                # (B,t,s,H,dk)
        E = torch.exp(torch.clamp_max(dlt, 0.0))
        A = torch.einsum("bthd,bshd,btshd->bhts", rc, kc, E)
        A = torch.where(tri, A, 0.0)
        o = torch.einsum("bhts,bshd->bthd", A, vc)
        if uf is not None:
            diag = torch.einsum("bthd,bthd->bth", rc * uf, kc)
            o = o + diag[..., None] * vc
        # inter-chunk: the carried state's contribution
        o = o + torch.einsum("bthd,bhdv->bthv", q_eff, state)
        # state update
        lcw_c = lcw[:, -1:]                                      # (B,1,H,dk)
        k2 = kc * torch.exp(lcw_c - lcw)
        state = state * torch.exp(lcw_c[:, 0])[..., None] + torch.einsum(
            "bshd,bshv->bhdv", k2, vc)
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, S, H, dv)[:, :S_orig]
    return o.to(v.dtype), state


def decay_attention_chunk_parallel(r, k, v, w_log, u=None,
                                   initial_state=None, chunk: int = 64,
                                   sub: int = 16, factors=None):
    """The kernel's decomposition (``csrc/linear_attn_chunk.cu``) of the
    function ``decay_attention_chunked`` computes, same operands and
    results (per-channel log-decay w <= 0).

    Per chunk, independently: lcw the inclusive cumulative log-decay,
    lcw_excl = lcw - w; the scores A[t, s] (s < t) by sub-chunks of
    ``sub``: a diagonal block pairwise, r[t] k[s] exp(min(lcw_excl[t] -
    lcw[s], 0)); an off-diagonal block (t in sub-chunk i, s in j < i)
    through L = lcw at the end of sub-chunk j, as the product of
    r[t] exp(min(lcw_excl[t] - L, 0)) and k[s] exp(min(L - lcw[s], 0)),
    each at most 1 (the min absorbs only rounding);
    o_intra = A v + (r . u k) v, q_eff = r exp(lcw_excl), the state
    increment k2^T v with k2 = k exp(lcw[-1] - lcw) and the decay
    exp(lcw[-1]).  Then the scan: o = o_intra + q_eff S, S <- decay S +
    dS.  ``factors``, a list, collects the off-diagonal factors."""
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    rf, kf, vf, wf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad))
                      .reshape(B, nc, chunk, H, t.shape[-1])
                      for t in (r, k, v, w_log))               # (B,n,c,H,d)
    lcw = torch.cumsum(wf, dim=2)
    excl = lcw - wf
    ns = chunk // sub
    A = torch.zeros((B, nc, H, chunk, chunk), device=k.device)
    tri = torch.ones((sub, sub), dtype=torch.bool,
                     device=k.device).tril(-1)
    blk = lambda x, i: x[:, :, i * sub:(i + 1) * sub]
    for i in range(ns):
        dlt = blk(excl, i)[:, :, :, None] - blk(lcw, i)[:, :, None]
        E = torch.exp(torch.clamp_max(dlt, 0.0))          # (B,n,t,s,H,d)
        a = torch.einsum("bnthd,bnshd,bntshd->bnhts", blk(rf, i),
                         blk(kf, i), E)
        A[..., i * sub:(i + 1) * sub, i * sub:(i + 1) * sub] = \
            torch.where(tri, a, 0.0)
        for j in range(i):
            ref = lcw[:, :, (j + 1) * sub - 1][:, :, None]   # (B,n,1,H,d)
            fr = torch.exp(torch.clamp_max(blk(excl, i) - ref, 0.0))
            fk = torch.exp(torch.clamp_max(ref - blk(lcw, j), 0.0))
            if factors is not None:
                factors += [fr, fk]
            A[..., i * sub:(i + 1) * sub, j * sub:(j + 1) * sub] = \
                torch.einsum("bnthd,bnshd->bnhts", blk(rf, i) * fr,
                             blk(kf, j) * fk)
    o_intra = torch.einsum("bnhts,bnshv->bnthv", A, vf)
    if u is not None:
        diag = torch.einsum("bnthd,bnthd->bnth", rf * u.float(), kf)
        o_intra = o_intra + diag[..., None] * vf
    q_eff = rf * torch.exp(excl)
    last = lcw[:, :, -1:]                                      # (B,n,1,H,d)
    dstate = torch.einsum("bnshd,bnshv->bnhdv",
                          kf * torch.exp(last - lcw), vf)
    decay = torch.exp(last[:, :, 0])                           # (B,n,H,d)
    state = (torch.zeros((B, H, dk, dv), device=k.device)
             if initial_state is None else initial_state.float())
    outs = []
    for c in range(nc):
        outs.append(o_intra[:, c] + torch.einsum("bthd,bhdv->bthv",
                                                 q_eff[:, c], state))
        state = state * decay[:, c][..., None] + dstate[:, c]
    o = torch.stack(outs, dim=1).reshape(B, nc * chunk, H, dv)[:, :S]
    return o.to(v.dtype), state


def linear_attn_ref(r, k, v, w_log, u=None):
    """r/k/w_log: (B,H,S,dk); v: (B,H,S,dv); u: (H,dk) or None.  The
    token-by-token recurrence from a zero state; returns o (B,H,S,dv) in
    v's dtype."""
    B, H, S, dk = k.shape
    dv = v.shape[-1]
    state = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=k.device)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w_log))
    outs = []
    for t in range(S):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        o = torch.einsum("bhd,bhdv->bhv", rt, state)
        if u is not None:
            o = o + torch.einsum("bhd,bhd->bh", rt * u.float()[None],
                                 kt)[..., None] * vt
        state = state * torch.exp(wt)[..., None] + \
            kt[..., None] * vt[:, :, None]
        outs.append(o)
    return torch.stack(outs, dim=2).to(v.dtype)
