"""K6 under autograd (``kernels/linear_attn_chunk/ops.py::
LinearAttnChunk``) against JAX's gradient of the function it computes.

JAX's trainer differentiates the jnp ``decay_attention_chunked``
(``repro/models/ssm.py``); the port's wrapper launches K6 in the forward
and the backward kernels (``csrc/linear_attn_chunk_bwd.cu``) in the
backward on the card, and on the CPU runs the plain version and
differentiates it in fp32.  On the CPU, fp32, inputs from a numpy seed:

* the gradients of r, k, v, w_log, u and the initial state of a loss
  that reads the output and the final state, against ``jax.grad``:
  relative L2 within 1e-4 (``tests/test_torch_losses.py``'s bound), the
  output and the final state within 1e-5; with u and an initial state
  and without, S not a multiple of the chunk (the tail pad), chunks of 16
  and 64;
* a loss that never reads the final state (training's case: its
  gradient is None) gives the same gradients as one that reads it with
  weight zero, and a loss of the state alone those of autograd through
  the plain version (r and u take none);
* bf16 operands get bf16 gradients (each in its input's dtype), u and the
  decay fp32;
* nothing is launched or counted on the CPU (``grad_launches`` too).

gpu-marked, on the card, without JAX: K6's output within its tolerance
of the plain version, one launch, one scan and one ``grad_launches`` a
call, one backward call (``bwd_launches``; ``bwd_du_launches`` too
where u is given), and gradients, each in its
operand's dtype, within relative L2 1e-4 (fp32) or 5e-3 (bf16) of
autograd through the plain version in fp32 on the same operands:

    python -m pytest --noconftest -m gpu tests/test_torch_k6_grad.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.linear_attn_chunk import ops  # noqa: E402
from repro_torch.kernels.linear_attn_chunk.ref import \
    decay_attention_chunked  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import decay_attention_chunked as jax_chunked
except ImportError:                       # the card's machine has no JAX
    jax = None

torch.set_num_threads(2)
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")
GRAD_REL = 1e-4
NAMES = ("r", "k", "v", "w_log", "u", "initial_state")


def _operands(seed, B, S, H, *, use_u, use_state, d=64):
    """fp32 numpy operands and the loss weights of o and the state."""
    rs = np.random.default_rng(seed)
    n = lambda *s: rs.standard_normal(s, dtype=np.float32)
    ops_ = {"r": n(B, S, H, d), "k": n(B, S, H, d), "v": n(B, S, H, d),
            "w_log": -np.exp(n(B, S, H, d) * 0.5 - 1.0).astype(np.float32),
            "u": n(H, d) * 0.1 if use_u else None,
            "initial_state": n(B, H, d, d) if use_state else None}
    return ops_, n(B, S, H, d), n(B, H, d, d)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_grads(fn, operands, wo, ws, chunk, read_state=True,
                read_out=True):
    """(o, state, {name: grad}) of sum(o * wo) + sum(state * ws) through
    ``fn`` (either term left out on request), each given operand a leaf;
    a leaf the loss does not reach gets None."""
    leaves = {k: None if v is None else v.detach().clone().requires_grad_()
              for k, v in operands.items()}
    o, st = fn(*(leaves[k] for k in NAMES), chunk=chunk)
    loss = (o.float() * wo).sum() if read_out else 0.0
    if read_state:
        loss = loss + (st * ws).sum()
    given = [k for k in NAMES if leaves[k] is not None]
    grads = torch.autograd.grad(loss, [leaves[k] for k in given],
                                allow_unused=True)
    return o.detach(), st.detach(), dict(zip(given, grads))


CASES = [  # (S, chunk, use_u, use_state)
    (70, 64, True, True), (70, 16, False, False), (128, 16, True, False),
    (45, 64, False, True)]


@needs_jax
@pytest.mark.parametrize("S,chunk,use_u,use_state", CASES)
def test_grads_match_jax(S, chunk, use_u, use_state):
    npo, wo, ws = _operands(S + chunk, 2, S, 2, use_u=use_u,
                            use_state=use_state)
    given = [k for k in NAMES if npo[k] is not None]

    def jloss(args):
        full = dict(npo, **args)
        o, st = jax_chunked(*(None if full[k] is None else full[k]
                              for k in NAMES), chunk=chunk)
        return jnp.sum(o * wo) + jnp.sum(st * ws), (o, st)

    (_, (jo, jst)), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(npo[k]) for k in given})
    kernels.reset_counts()
    o, st, g = _port_grads(ops.linear_attn_bshd, {
        k: None if v is None else torch.from_numpy(v)
        for k, v in npo.items()}, torch.from_numpy(wo),
        torch.from_numpy(ws), chunk)
    assert all(n == 0 for n in kernels.launch_counts().values())
    assert _rel(o, jo) < 1e-5 and _rel(st, jst) < 1e-5
    assert sorted(g) == sorted(given)
    for k in given:
        assert _rel(g[k], jg[k]) <= GRAD_REL, k


def test_unread_final_state_takes_no_gradient():
    npo, wo, ws = _operands(3, 1, 70, 2, use_u=True, use_state=True)
    t = {k: torch.from_numpy(v) for k, v in npo.items()}
    wo, ws = torch.from_numpy(wo), torch.from_numpy(ws)
    _, _, unread = _port_grads(ops.linear_attn_bshd, t, wo, ws, 64,
                               read_state=False)
    _, _, zero = _port_grads(ops.linear_attn_bshd, t, wo, ws * 0, 64)
    for k in NAMES:
        assert torch.equal(unread[k], zero[k]), k
    # and a loss of the state alone, which r and u do not reach
    _, _, only = _port_grads(ops.linear_attn_bshd, t, wo, ws, 64,
                             read_out=False)
    _, _, ref = _port_grads(decay_attention_chunked, t, wo, ws, 64,
                            read_out=False)
    for k in NAMES:
        if k in ("r", "u"):
            assert only[k] is None and ref[k] is None, k
        else:
            assert torch.equal(only[k], ref[k]), k


def test_bf16_operands_get_bf16_gradients():
    npo, wo, ws = _operands(4, 1, 40, 2, use_u=True, use_state=True)
    t = {k: torch.from_numpy(v) for k, v in npo.items()}
    for k in ("r", "k", "v"):
        t[k] = t[k].bfloat16()
    o, st, g = _port_grads(ops.linear_attn_bshd, t, torch.from_numpy(wo),
                           torch.from_numpy(ws), 64)
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    for k in NAMES:
        assert g[k].dtype == t[k].dtype and torch.isfinite(g[k]).all(), k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_CASES = [  # (dtype, S, use_u, use_state, tol)
    (torch.float32, 200, True, True, 1e-4),
    (torch.bfloat16, 1024, True, False, 2e-2),
    (torch.bfloat16, 500, False, True, 2e-2)]


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA card (CUDA)")
@pytest.mark.parametrize("dtype,S,use_u,use_state,tol", GPU_CASES)
def test_k6_autograd_on_the_card(dtype, S, use_u, use_state, tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    npo, wo, ws = _operands(S, 1, S, 32, use_u=use_u, use_state=use_state)
    t = {k: None if v is None else torch.from_numpy(v).cuda()
         for k, v in npo.items()}
    for k in ("r", "k", "v"):
        t[k] = t[k].to(dtype)
    wo, ws = torch.from_numpy(wo).cuda(), torch.from_numpy(ws).cuda()
    kernels.reset_counts()
    o, st, g = _port_grads(ops.linear_attn_bshd, t, wo, ws, 64)
    assert (ops.launches, ops.scan_launches, ops.grad_launches) == (1, 1, 1)
    assert (ops.bwd_launches, ops.bwd_du_launches) == (1, int(use_u))
    t32 = {k: None if x is None else x.float() for k, x in t.items()}
    ro, rst, rg = _port_grads(decay_attention_chunked, t32, wo, ws, 64)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, rst, atol=tol, rtol=tol)
    bound = 1e-4 if dtype == torch.float32 else 5e-3
    for k in rg:
        assert g[k].dtype == t[k].dtype and torch.isfinite(g[k]).all(), k
        assert _rel(g[k].float().cpu(), rg[k].cpu()) <= bound, k
