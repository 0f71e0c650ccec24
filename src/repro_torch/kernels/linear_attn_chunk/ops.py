"""Model-layout wrapper of the chunked decay linear attention kernel K6
(port of ``repro/kernels/linear_attn_chunk/ops.py::linear_attn_bshd``,
with the initial and final state that ``repro/models/ssm.py::
decay_attention_chunked`` adds).

The wrapper validates its inputs and dispatches on the device the tensors
lie on: CPU tensors take the plain version (``ref.py``), CUDA tensors
launch the kernel or raise, ``meta`` tensors charge the cost counter one
call (``launch/op_cost.py``) and return empty outputs (under autograd
too; the backward is then counted as the plain version's ops).  There
is no fallback from one to the other.  ``launches`` counts kernel
launches, and only those: one per call, the chunk-parallel pass;
``scan_launches`` counts the scan of the state that each call launches
after it; ``grad_launches`` those calls made under autograd.  S need not
be a chunk multiple: the plain version pads with k = 0, w_log = 0 (decay 1,
nothing added; exact), and the kernel reads the same zeros past S.  The
scalar decay of Mamba2 (``w_log`` of last dim 1) is not taken yet.

Under autograd (grad mode on and an operand requiring a gradient) a call
goes through ``LinearAttnChunk``, a ``torch.autograd.Function``: its
forward launches K6 as above, and its backward recomputes the plain
version in fp32 on the saved operands and differentiates it.  JAX has no
backward kernel either: its trainer differentiates the jnp
``decay_attention_chunked`` that ``ref.py`` ports.  The final state's
gradient may be absent (training never reads the state).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_attn_chunk import kernel as _k
from repro_torch.kernels.linear_attn_chunk.ref import decay_attention_chunked
from repro_torch.launch.op_cost import dtype_name, k6_charge, record_kernel

launches = 0                  # chunk-kernel launches since the last reset
scan_launches = 0             # scan launches since the last reset
grad_launches = 0             # of which under autograd (LinearAttnChunk)


def check_operands(r, k, v, w_log, u, initial_state, chunk: int) -> None:
    if k.dim() != 4:
        raise ValueError(f"k must be (B, S, H, dk), got {tuple(k.shape)}")
    B, S, H, dk = k.shape
    if w_log.shape[:3] == (B, S, H) and w_log.shape[-1] == 1 and dk != 1:
        raise NotImplementedError("a scalar (per-head) decay is Mamba2's "
                                  "form, which K6 does not take yet")
    if r.shape != k.shape or w_log.shape != k.shape:
        raise ValueError(f"r and w_log must be {tuple(k.shape)}, got "
                         f"{tuple(r.shape)} / {tuple(w_log.shape)}")
    if v.dim() != 4 or v.shape[:3] != (B, S, H):
        raise ValueError(f"v must be ({B}, {S}, {H}, dv), got "
                         f"{tuple(v.shape)}")
    if u is not None and u.shape != (H, dk):
        raise ValueError(f"u must be ({H}, {dk}), got {tuple(u.shape)}")
    if initial_state is not None and \
            initial_state.shape != (B, H, dk, v.shape[-1]):
        raise ValueError(f"initial_state must be ({B}, {H}, {dk}, "
                         f"{v.shape[-1]}), got {tuple(initial_state.shape)}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def check_cuda_operands(r, k, v, w_log, u, initial_state, chunk: int) -> None:
    given = [t for t in (r, k, v, w_log, u, initial_state) if t is not None]
    if any(t.device != k.device for t in given):
        raise ValueError("all operands must lie on one CUDA device")
    if k.dtype not in _k.DTYPE_CODES:
        raise ValueError(f"unsupported dtype {k.dtype}")
    if r.dtype != k.dtype or v.dtype != k.dtype:
        raise ValueError("r, k and v must share one dtype")
    if any(t.dtype != torch.float32 for t in given[3:]):
        raise ValueError("w_log, u and initial_state must be float32")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("the kernel takes contiguous operands only")
    if k.shape[-1] != _k.HEAD_DIM or v.shape[-1] != _k.HEAD_DIM:
        raise ValueError(f"the kernel takes dk = dv = {_k.HEAD_DIM}")
    if chunk not in _k.CHUNKS:
        raise ValueError(f"chunk {chunk} not in {_k.CHUNKS}")


def linear_attn_bshd(r, k, v, w_log, u=None, initial_state=None, *,
                     chunk: int = 64):
    """r/k/w_log: (B,S,H,dk); v: (B,S,H,dv); u: (H,dk) or None;
    initial_state: (B,H,dk,dv) fp32 or None (zeros).

    Returns (o (B,S,H,dv) in v's dtype, final_state (B,H,dk,dv) fp32)."""
    args = (r, k, v, w_log, u, initial_state)
    check_operands(*args, chunk)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return LinearAttnChunk.apply(*args, chunk)
    return _forward(*args, chunk)


def _forward(r, k, v, w_log, u, initial_state, chunk: int):
    """The plain version on the CPU, the kernel on CUDA (validated,
    counted); operands already checked by the wrapper."""
    global launches, scan_launches
    args = (r, k, v, w_log, u, initial_state)
    if k.device.type == "cpu":
        return decay_attention_chunked(*args, chunk=chunk)
    if k.device.type not in ("cuda", "meta"):
        raise ValueError(f"no linear_attn_chunk for device {k.device}")
    check_cuda_operands(*args, chunk)
    B, S, H, dk = k.shape
    o = torch.empty_like(v)
    final_state = torch.empty((B, H, dk, v.shape[-1]), dtype=torch.float32,
                              device=k.device)
    if k.device.type == "meta":
        _k.scratch(B, S, H, chunk, k.device)     # as the launch allocates
        shape = dict(B=B, S=S, H=H, d=dk, dtype=dtype_name(k.dtype))
        record_kernel("linear_attn_chunk", k6_charge(**shape), **shape)
        return o, final_state
    rc = _k.launch(*args, o, final_state, chunk=chunk)
    if rc != 0:
        raise RuntimeError(f"linear_attn_chunk launch failed: CUDA error {rc}")
    launches += 1
    scan_launches += 1
    return o, final_state


class LinearAttnChunk(torch.autograd.Function):
    """K6 with a gradient: the forward launches the kernel (the plain
    version on the CPU), the backward recomputes the plain version in
    fp32 on the saved operands and differentiates it."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, initial_state, chunk: int):
        global grad_launches
        out = _forward(r, k, v, w_log, u, initial_state, chunk)
        grad_launches += k.device.type == "cuda"
        ctx.save_for_backward(r, k, v, w_log, u, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, grad_o, grad_state):
        saved = [None if t is None else
                 t.detach().float().requires_grad_(need)
                 for t, need in zip(ctx.saved_tensors,
                                    ctx.needs_input_grad[:6])]
        wanted = [t for t in saved if t is not None and t.requires_grad]
        given = [(i, g) for i, g in enumerate((grad_o, grad_state))
                 if g is not None]
        with torch.enable_grad():
            outs = decay_attention_chunked(*saved, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                [outs[i] for i, _ in given], wanted,
                [g.float() for _, g in given], allow_unused=True))
        res = []
        for t, src in zip(saved, ctx.saved_tensors):
            g = next(grads) if t is not None and t.requires_grad else None
            res.append(None if g is None else g.to(src.dtype))
        return (*res, None)
