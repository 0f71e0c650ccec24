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
* ``chunk_states`` and ``decay_attention_chunked_bwd`` are the plain
  versions of the backward kernels (``csrc/linear_attn_chunk_bwd.cu``):
  the states entering each chunk (what the forward's scan saves under
  autograd), then the gradients of ``decay_attention_chunked`` in the
  kernels' decomposition.  The CPU tests hold them against ``jax.vjp``
  and autograd, and ``chip_smoke.py`` holds the kernels against them on
  the card; nothing on the main path runs them (the CPU backward
  differentiates ``decay_attention_chunked`` itself).
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


def _chunks(t, chunk: int):
    """(B, S, H, d) -> fp32 (B, n_chunks, chunk, H, d), zero past S."""
    S = t.shape[1]
    pad = -S % chunk
    return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).reshape(
        t.shape[0], (S + pad) // chunk, chunk, *t.shape[2:])


def chunk_states(k, v, w_log, initial_state=None, chunk: int = 64):
    """The fp32 state entering each chunk, (B, H, n_chunks, dk, dv): what
    the kernel's forward scan writes under autograd (``S_in``)."""
    B, _, H, dk = k.shape
    kf, vf, wf = (_chunks(t, chunk) for t in (k, v, w_log))
    lcw = torch.cumsum(wf, dim=2)
    last = lcw[:, :, -1:]
    dstate = torch.einsum("bnshd,bnshv->bnhdv", kf * torch.exp(last - lcw),
                          vf)
    decay = torch.exp(last[:, :, 0])[..., None]              # (B,n,H,dk,1)
    state = (torch.zeros((B, H, dk, v.shape[-1]), device=k.device)
             if initial_state is None else initial_state.float())
    states = []
    for c in range(kf.shape[1]):
        states.append(state)
        state = state * decay[:, c] + dstate[:, c]
    return torch.stack(states, dim=2)


def decay_attention_chunked_bwd(r, k, v, w_log, u, states, do, d_state=None,
                                chunk: int = 64, sub: int = 16):
    """The gradients of ``decay_attention_chunked`` in the backward
    kernel's decomposition (``csrc/linear_attn_chunk_bwd.cu``), all fp32.

    ``states`` are the states entering each chunk (``chunk_states``);
    ``do`` the output's cotangent (B, S, H, dv); ``d_state`` the final
    state's, or None (zero).  Per chunk, with L the inclusive cumulative
    log-decay, E = L - w the exclusive one and L_last = L at the chunk's
    end:

    * the reverse scan: dS_out of the last chunk is ``d_state``;
      dS_in = exp(L_last) dS_out + sum_t (r_t exp(E_t)) do_t^T, and
      dS_in of chunk 0 is the initial state's gradient;
    * dA[t, s] = do_t . v_s (s < t), and A recomputed; both of their
      decay-weighted products by sub-chunks of ``sub``: a diagonal block
      pairwise, exp(min(E_t - L_s, 0)), an off-diagonal one factored
      through L at the end of the earlier sub-chunk (each factor <= 1);
    * dv = A^T do + (r . u k) do + (k exp(L_last - L)) dS_out;
      dr = [intra] + exp(E) S_in do + u k (do . v);
      dk = [intra] + exp(L_last - L) dS_out v + u r (do . v);
    * dw from the parts that carry a decay: gE_t = r_t dr_w, gL_s =
      -k_s dk_w, plus, at the chunk's last position, sum_s k_s dk_state_s
      + exp(L_last) sum_e dS_out S_in; dw_t = sum_{t' >= t} (gE + gL) -
      gE_t (E_t sums the decays before t, L_t those up to t);
    * du = sum over b and t of r_t k_t (do_t . v_t).

    Returns (dr, dk, dv, dw, du or None, d_initial_state)."""
    B, S, H, dk = k.shape
    dv = v.shape[-1]
    rf, kf, vf, wf, df = (_chunks(t, chunk) for t in (r, k, v, w_log, do))
    nc = rf.shape[1]
    L = torch.cumsum(wf, dim=2)
    E = L - wf
    last = L[:, :, -1:]
    q_eff = rf * torch.exp(E)
    k2 = kf * torch.exp(last - L)
    decay = torch.exp(last[:, :, 0])[..., None]              # (B,n,H,dk,1)
    s_in = states.float().transpose(1, 2)                    # (B,n,H,dk,dv)
    # the reverse scan
    g = (torch.zeros((B, H, dk, dv), device=k.device) if d_state is None
         else d_state.float())
    ds_out = [None] * nc
    for c in reversed(range(nc)):
        ds_out[c] = g
        g = g * decay[:, c] + torch.einsum("bthd,bthv->bhdv", q_eff[:, c],
                                           df[:, c])
    d_s0 = g
    ds_out = torch.stack(ds_out, dim=1)                      # (B,n,H,dk,dv)
    # the chunk-parallel gradients
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=k.device).tril(-1)
    dA = torch.where(tri, torch.einsum("bnthv,bnshv->bnhts", df, vf), 0.0)
    A = torch.zeros_like(dA)
    dr_w = torch.zeros_like(rf)
    dk_w = torch.zeros_like(kf)
    blk = lambda x, i: x[:, :, i * sub:(i + 1) * sub]
    part = lambda x, i, j: x[..., i * sub:(i + 1) * sub,
                             j * sub:(j + 1) * sub]
    stri = torch.ones((sub, sub), dtype=torch.bool,
                      device=k.device).tril(-1)
    for i in range(chunk // sub):
        sl = slice(i * sub, (i + 1) * sub)
        dlt = blk(E, i)[:, :, :, None] - blk(L, i)[:, :, None]
        fd = torch.where(stri[:, :, None, None],
                         torch.exp(torch.clamp_max(dlt, 0.0)), 0.0)
        ri, ki, da = blk(rf, i), blk(kf, i), part(dA, i, i)
        A[..., sl, sl] = torch.einsum("bnthd,bnshd,bntshd->bnhts", ri, ki, fd)
        dr_w[:, :, sl] += torch.einsum("bnhts,bnshd,bntshd->bnthd", da, ki,
                                       fd)
        dk_w[:, :, sl] += torch.einsum("bnhts,bnthd,bntshd->bnshd", da, ri,
                                       fd)
        for j in range(i):
            sj = slice(j * sub, (j + 1) * sub)
            ref = L[:, :, (j + 1) * sub - 1][:, :, None]     # (B,n,1,H,d)
            fr = torch.exp(torch.clamp_max(blk(E, i) - ref, 0.0))
            fk = torch.exp(torch.clamp_max(ref - blk(L, j), 0.0))
            rs, ks, da = ri * fr, blk(kf, j) * fk, part(dA, i, j)
            A[..., sl, sj] = torch.einsum("bnthd,bnshd->bnhts", rs, ks)
            dr_w[:, :, sl] += fr * torch.einsum("bnhts,bnshd->bnthd", da, ks)
            dk_w[:, :, sj] += fk * torch.einsum("bnhts,bnthd->bnshd", da, rs)
    dov = (df * vf).sum(-1, keepdim=True)                    # (B,n,c,H,1)
    d_v = (torch.einsum("bnhts,bnthv->bnshv", A, df)
           + torch.einsum("bnshd,bnhdv->bnshv", k2, ds_out))
    dr_w = dr_w + torch.exp(E) * torch.einsum("bnhdv,bnthv->bnthd", s_in, df)
    dk_state = torch.exp(last - L) * torch.einsum("bnhdv,bnshv->bnshd",
                                                  ds_out, vf)
    dk_w = dk_w + dk_state
    d_r, d_k, d_u = dr_w, dk_w, None
    if u is not None:
        uf = u.float()
        d_v = d_v + (rf * uf * kf).sum(-1, keepdim=True) * df
        d_r = d_r + uf * kf * dov
        d_k = d_k + uf * rf * dov
        d_u = (rf * kf * dov).sum(dim=(0, 1, 2))
    gE = rf * dr_w
    gL = -kf * dk_w
    gL[:, :, -1] += (kf * dk_state).sum(2) + decay[..., 0] * (
        ds_out * s_in).sum(-1)
    tot = gE + gL
    d_w = tot.flip(2).cumsum(2).flip(2) - gE
    unchunk = lambda t: t.reshape(B, nc * chunk, H, t.shape[-1])[:, :S]
    return (unchunk(d_r), unchunk(d_k), unchunk(d_v), unchunk(d_w), d_u,
            d_s0)


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
