"""K3's backward (a whole prefill): the explicit plain backward in the
backward kernel's decomposition (``kernels/flash_attention/kernel.py``:
``flash_attention_lse_plain``, then ``flash_attention_bwd_plain``: delta,
dK/dV by key tiles, dQ by query tiles) against ``jax.vjp`` of the JAX
function it differentiates (``repro/models/layers.py::
blocked_attention``) and against autograd through the port's plain
forward, in fp32 on the CPU, operands and the output's cotangent from a
numpy seed: relative L2 within 1e-4 for each of dq, dk and dv.  Cases:
the five widths of K3's builds, (64, 64), (80, 80), (128, 128), (256,
256) and (192, 128), and fp32's (48, 32), run in fp32; G = 1, 3, 4 and 8 (one kv head:
each query head's dK/dV summed over the group in order, as the kernels
sum their per-head partials); causal and bidirectional; window 0 and 512
at S past the window, and windows that cross a tile's edge or mask whole
key tiles; S not a multiple of the tiles; MLA's scale 1/sqrt(nd + rd).

gpu-marked, on the card, without JAX (the file imports JAX inside a
``try``): the backward kernels (``csrc/flash_attention_bwd.cu``) against
the plain backward on the same operands at every build training runs,
fp32 within relative L2 1e-4 and bf16 within 5e-3 of the plain version in
fp32 on the same bf16 operands (a gradient 1% off failing that bound),
two identical calls bitwise equal; the forward's output bitwise the same
with and without the log-sum-exp pointer, the log-sum-exp within 1e-4 of
its plain version; and the autograd wrapper on CUDA with the plain
functions patched to raise, so that its gradients can only come from the
kernels:

    python -m pytest --noconftest -m gpu tests/test_torch_k3_bwd.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k3k  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k3  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.models.layers import blocked_attention as jax_blocked
except ImportError:                       # the card's machine has no JAX
    jax = None

torch.set_num_threads(2)
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")
REL = 1e-4
BF16_REL = 5e-3
MLA_SCALE = 1 / math.sqrt(128 + 64)

# (name, Hq, Hkv, Dqk, Dv, S, causal, window, scale)
CASES = [
    ("64 G1 causal", 2, 2, 64, 64, 96, True, 0, None),
    ("80 G1 bidirectional", 2, 2, 80, 80, 70, False, 0, None),
    ("128 G3 causal ragged", 6, 2, 128, 128, 100, True, 0, None),
    ("128 G3 bidirectional", 3, 1, 128, 128, 83, False, 0, None),
    ("256 G4 window 512", 4, 1, 256, 256, 600, True, 512, None),
    ("256 G4 global", 4, 1, 256, 256, 530, True, 0, None),
    ("192/128 G1 MLA scale", 2, 2, 192, 128, 150, True, 0, MLA_SCALE),
    ("64 G4 window 512 ragged", 4, 1, 64, 64, 555, True, 512, None),
    # the per-head dK/dV partials and their group sum: Hkv = 1 at G = 4
    # and 8, S past a multiple of the kernels' tiles (32 and 64), windows
    # that cross a tile's edge, and query tiles whose first key tiles are
    # wholly masked (window 16 against keys 0-63 from query 80 on)
    ("256 G8 window 40 ragged", 8, 1, 256, 256, 150, True, 40, None),
    ("64 G4 window 16 masked first tile", 4, 1, 64, 64, 100, True, 16,
     None),
    ("128 G8 window 70 ragged", 8, 1, 128, 128, 233, True, 70, None),
    ("80 G4 causal ragged", 4, 1, 80, 80, 97, True, 0, None),
    ("192/128 G4 window 33 MLA scale", 4, 1, 192, 128, 129, True, 33,
     MLA_SCALE),
    # the fp32 build of deepseek-v2-lite's reduced MLA widths
    ("48/32 G2 reduced MLA", 4, 2, 48, 32, 90, True, 0, 1 / math.sqrt(48)),
]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _operands(case, B=2):
    _, hq, hkv, dqk, dv, S, *_ = case
    rs = np.random.default_rng(S + dqk)
    n = lambda *s: rs.standard_normal(s, dtype=np.float32)
    return n(B, S, hq, dqk), n(B, S, hkv, dqk), n(B, S, hkv, dv), \
        n(B, S, hq, dv)


def _plain_bwd(q, k, v, do, *, causal, window, scale):
    """The plain forward's output and log-sum-exp, then the explicit
    plain backward: (dq, dk, dv) fp32."""
    kw = dict(causal=causal, window=window, scale=scale)
    out = k3k.flash_attention_plain(q, k, v, **kw)
    lse = k3k.flash_attention_lse_plain(q, k, **kw)
    return k3k.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)


@needs_jax
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_jax_vjp(case):
    *_, S, causal, window, scale = case
    q, k, v, do = _operands(case)
    pos = jnp.arange(S)
    fn = lambda a, b, c: jax_blocked(
        a, b, c, jnp.broadcast_to(pos, (q.shape[0], S)), pos,
        window=window, causal=causal, scale=scale)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _plain_bwd(*(torch.from_numpy(x) for x in (q, k, v, do)),
                     causal=causal, window=window, scale=scale)
    for a, b, what in zip(got, want, "qkv"):
        assert _rel(a, b) <= REL, f"d{what}"


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_autograd(case):
    *_, causal, window, scale = case
    q, k, v, do = (torch.from_numpy(x) for x in _operands(case))
    kw = dict(causal=causal, window=window, scale=scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k3k.flash_attention_plain(*leaves, **kw)
    want = torch.autograd.grad((out * do).sum(), leaves)
    got = _plain_bwd(q, k, v, do, **kw)
    for a, b, what in zip(got, want, "qkv"):
        assert a.shape == b.shape and _rel(a, b) <= REL, f"d{what}"
    # the log-sum-exp over the admitted keys normalises each row
    lse = k3k.flash_attention_lse_plain(q, k, **kw)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert torch.isfinite(lse).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs an NVIDIA card (CUDA)")

# every K3 build training runs: (name, dtype, Hq, Hkv, Dqk, Dv, S, causal,
# window, scale); fp32 at every build, unpadded
GPU_CASES = [
    ("gemma3 bf16 256 window 512", torch.bfloat16, 4, 1, 256, 256, 1024,
     True, 512, None),
    ("gemma3 bf16 256 global", torch.bfloat16, 4, 1, 256, 256, 1024, True,
     0, None),
    ("zamba2 bf16 64", torch.bfloat16, 32, 32, 64, 64, 1024, True, 0, None),
    ("deepseek bf16 192/128", torch.bfloat16, 16, 16, 192, 128, 1024, True,
     0, MLA_SCALE),
    ("deepseek-moe bf16 128", torch.bfloat16, 16, 16, 128, 128, 1000, True,
     0, None),
    ("hubert bf16 80 bidirectional", torch.bfloat16, 16, 16, 80, 80, 700,
     False, 0, None),
    ("fp32 64 G4", torch.float32, 8, 2, 64, 64, 300, True, 0, None),
    ("fp32 80 bidirectional", torch.float32, 4, 4, 80, 80, 200, False, 0,
     None),
    ("fp32 256 window", torch.float32, 4, 1, 256, 256, 333, True, 100,
     None),
    ("fp32 192/128 MLA", torch.float32, 4, 4, 192, 128, 200, True, 0,
     MLA_SCALE),
    # the per-head (and per-share) partials and their sum: gemma3-1b's
    # heads at S past the tiles with its window, and G = 8 over one kv head
    ("gemma3 bf16 256 S=1000 window 512", torch.bfloat16, 4, 1, 256, 256,
     1000, True, 512, None),
    ("bf16 128 G8 window 100", torch.bfloat16, 8, 1, 128, 128, 777, True,
     100, None),
    ("bf16 64 G8 over 2", torch.bfloat16, 16, 2, 64, 64, 300, True, 0, None),
    # two blocks share each key tile's queries (too few blocks for the
    # card), one query head per kv head: the shares' partials and their sum
    ("bf16 128 G1 split", torch.bfloat16, 2, 2, 128, 128, 300, True, 0,
     None),
    # fp32 (3xTF32): the split (B Hq ceil(S / rows) < 132) with G > 1 and
    # G = 1, no split with G = 1 (dK/dV written directly), gemma3-1b's
    # global layer at the 5e(iii) check's S, the reduced MLA widths
    ("fp32 128 G3 split", torch.float32, 6, 2, 128, 128, 300, True, 0,
     None),
    ("fp32 256 G4 global split", torch.float32, 4, 1, 256, 256, 512, True,
     0, None),
    ("fp32 64 G1 no split", torch.float32, 32, 32, 64, 64, 512, True, 0,
     None),
    ("fp32 48/32 reduced MLA", torch.float32, 4, 4, 48, 32, 150, True, 0,
     1 / math.sqrt(48)),
]


def _card(case, B=1):
    name, dtype, *rest = case
    q, k, v, do = _operands((name, *rest), B=B)
    return [torch.from_numpy(x).cuda().to(dtype) for x in (q, k, v, do)]


def kernel_grads(q, k, v, do, *, causal, window, scale):
    """The forward kernel (writing its log-sum-exp), then the backward
    kernels, through the wrapper's autograd function."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k3.flash_attention_bshd(*leaves, causal=causal, window=window,
                                  scale=scale)
    return torch.autograd.grad(out, leaves, do)


@gpu
@needs_cuda
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: c[0])
def test_k3_backward_kernels_against_plain(case):
    torch.backends.cuda.matmul.allow_tf32 = False
    *_, causal, window, scale = case
    kw = dict(causal=causal, window=window, scale=scale)
    q, k, v, do = _card(case)
    kernels.reset_counts()
    got = kernel_grads(q, k, v, do, **kw)
    again = kernel_grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert k3.bwd_launches == 2
    want = _plain_bwd(*(t.float() for t in (q, k, v, do)), **kw)
    bound = REL if q.dtype == torch.float32 else BF16_REL
    for a, b, x, c, what in zip(got, want, (q, k, v), again, "qkv"):
        assert a.dtype == x.dtype and a.shape == x.shape, what
        assert torch.equal(a, c), f"d{what}: not bitwise"
        rel = _rel(a.float().cpu(), b.cpu())
        assert rel <= bound, (what, rel)
        off = a.float().clone()
        off[..., 1::2] *= 1.01
        assert _rel(off.cpu(), b.cpu()) > bound, f"d{what}: 1% passes"


@gpu
@needs_cuda
@pytest.mark.parametrize("case", GPU_CASES, ids=lambda c: c[0])
def test_k3_forward_bits_with_the_lse_pointer(case):
    *_, causal, window, scale = case
    q, k, v, _ = _card(case, B=2)
    kw = dict(causal=causal, window=window, scale=scale)
    plain = k3._forward(q, k, v, **kw)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], device="cuda")
    with_lse = k3._forward(q, k, v, lse=lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_lse)
    want = k3k.flash_attention_lse_plain(q.float(), k.float(), **kw)
    assert torch.allclose(lse, want, atol=1e-4, rtol=1e-4)


@gpu
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_autograd_never_calls_the_plain_versions(dtype, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a plain K3 version ran on the card")

    for name in ("flash_attention_plain", "flash_attention_bwd_plain",
                 "flash_attention_lse_plain", "blocked_attention"):
        monkeypatch.setattr(k3k, name, refuse)
    case = GPU_CASES[0] if dtype == torch.bfloat16 else GPU_CASES[6]
    *_, causal, window, scale = case
    q, k, v, do = _card(case)
    kernels.reset_counts()
    grads = kernel_grads(q, k, v, do, causal=causal, window=window,
                         scale=scale)
    assert (k3.launches, k3.grad_launches, k3.bwd_launches) == (1,) * 3
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == x.dtype and torch.isfinite(g).all()
