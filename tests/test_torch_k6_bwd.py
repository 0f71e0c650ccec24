"""K6's backward: the explicit plain backward in the backward kernel's
decomposition (``kernels/linear_attn_chunk/ref.py::
decay_attention_chunked_bwd``: the states entering each chunk, the
reverse scan of the state's gradient, the chunk-parallel gradients by
sub-chunks of 16, du) against ``jax.vjp`` of the JAX function it
differentiates (``repro/models/ssm.py::decay_attention_chunked``) and
against autograd through the port's plain forward, in fp32 on the CPU,
operands and cotangents from a numpy seed: relative L2 within 1e-4 for
each of dr, dk, dv, dw, du and the initial state's gradient.  Cases: S a
multiple of the chunk and not, chunks 16 and 64, u and the initial state
present and absent, a final-state cotangent and none, strong decay
(log-decay down to -20 a step: every decay factor <= 1, and the exponents
of the pairwise and factored forms stay <= 0).

gpu-marked, on the card, without JAX (the file imports JAX inside a
``try``): the backward kernels (``csrc/linear_attn_chunk_bwd.cu``) against
the plain backward on the same operands, fp32 within relative L2 1e-4 and
bf16 within 5e-3 of the plain version in fp32 on the same bf16 operands
(a gradient 1% off failing that bound), two identical calls bitwise
equal, bf16 and fp32 (3xTF32) also at chunk 16 and two sequences, strong
decay and S not a chunk multiple (the tensor-core designs' increment,
carry and gradient pass); and the autograd wrapper on CUDA with the plain
functions patched to raise, so that its gradients can only come from the
kernels, fp32 also at both chunks and two sequences:

    python -m pytest --noconftest -m gpu tests/test_torch_k6_bwd.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.linear_attn_chunk import ops  # noqa: E402
from repro_torch.kernels.linear_attn_chunk import ref  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import decay_attention_chunked as jax_chunked
except ImportError:                       # the card's machine has no JAX
    jax = None

torch.set_num_threads(2)
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")
REL = 1e-4
BF16_REL = 5e-3
GRADS = ("r", "k", "v", "w_log", "u", "initial_state")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _operands(seed, B, S, H, *, use_u, use_s0, d_state, strong, d=64):
    """fp32 numpy operands, the output's cotangent and the final state's
    (or None)."""
    rs = np.random.default_rng(seed)
    n = lambda *s: rs.standard_normal(s, dtype=np.float32)
    w = (-20.0 * rs.random((B, S, H, d), dtype=np.float32) if strong
         else -np.exp(n(B, S, H, d) * 0.5 - 1.0).astype(np.float32))
    x = {"r": n(B, S, H, d), "k": n(B, S, H, d), "v": n(B, S, H, d),
         "w_log": w, "u": n(H, d) * 0.1 if use_u else None,
         "initial_state": n(B, H, d, d) if use_s0 else None}
    return x, n(B, S, H, d), n(B, H, d, d) if d_state else None


def _plain_bwd(x, do, ds, chunk):
    """The explicit plain backward on torch operands: {name: grad}."""
    states = ref.chunk_states(x["k"], x["v"], x["w_log"],
                              x["initial_state"], chunk)
    g = ref.decay_attention_chunked_bwd(
        x["r"], x["k"], x["v"], x["w_log"], x["u"], states, do, ds,
        chunk=chunk)
    return dict(zip(GRADS, g))


# (S, chunk, use_u, use_s0, d_state, strong)
CASES = [(128, 64, True, True, True, False),
         (70, 64, True, True, False, False),
         (70, 16, False, False, True, False),
         (45, 16, True, False, False, False),
         (100, 64, False, True, True, False),
         (300, 64, True, True, False, True),
         (96, 16, False, True, True, True),
         (257, 64, True, False, True, False),
         (200, 16, True, True, True, True)]
IDS = [f"S{c[0]}-c{c[1]}{'-u' if c[2] else ''}{'-s0' if c[3] else ''}"
       f"{'-dS' if c[4] else ''}{'-strong' if c[5] else ''}" for c in CASES]


@needs_jax
@pytest.mark.parametrize("S,chunk,use_u,use_s0,d_state,strong", CASES,
                         ids=IDS)
def test_plain_backward_matches_jax_vjp(S, chunk, use_u, use_s0, d_state,
                                        strong):
    x, do, ds = _operands(S + chunk, 2, S, 2, use_u=use_u, use_s0=use_s0,
                          d_state=d_state, strong=strong)
    given = [k for k in GRADS if x[k] is not None]
    fn = lambda *a: jax_chunked(
        *(dict(zip(given, a)).get(k) for k in GRADS), chunk=chunk)
    (jo, jst), vjp = jax.vjp(fn, *(jnp.asarray(x[k]) for k in given))
    cot = (jnp.asarray(do), jnp.zeros_like(jst) if ds is None
           else jnp.asarray(ds))
    want = dict(zip(given, vjp(cot)))
    t = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    got = _plain_bwd(t, torch.from_numpy(do),
                     None if ds is None else torch.from_numpy(ds), chunk)
    for k in given:
        assert _rel(got[k], want[k]) <= REL, k
    if not use_u:
        assert got["u"] is None


@pytest.mark.parametrize("S,chunk,use_u,use_s0,d_state,strong", CASES,
                         ids=IDS)
def test_plain_backward_matches_autograd(S, chunk, use_u, use_s0, d_state,
                                         strong):
    x, do, ds = _operands(S + 2 * chunk, 2, S, 2, use_u=use_u,
                          use_s0=use_s0, d_state=d_state, strong=strong)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in x.items()}
    do, ds = torch.from_numpy(do), None if ds is None else \
        torch.from_numpy(ds)
    leaves = {k: None if v is None else v.clone().requires_grad_()
              for k, v in t.items()}
    o, st = ref.decay_attention_chunked(*(leaves[k] for k in GRADS),
                                        chunk=chunk)
    loss = (o * do).sum() + (0.0 if ds is None else (st * ds).sum())
    given = [k for k in GRADS if leaves[k] is not None]
    want = dict(zip(given, torch.autograd.grad(
        loss, [leaves[k] for k in given])))
    got = _plain_bwd(t, do, ds, chunk)
    for k in given:
        assert _rel(got[k], want[k]) <= REL, k
    # the first chunk enters with the initial state (zero without one)
    states = ref.chunk_states(t["k"], t["v"], t["w_log"],
                              t["initial_state"], chunk)
    assert states.shape == (2, 2, -(-S // chunk), 64, 64)
    s0 = t["initial_state"]
    assert torch.equal(states[:, :, 0], torch.zeros_like(states[:, :, 0])
                       if s0 is None else s0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs an NVIDIA card (CUDA)")

# (dtype, S, H, chunk, use_u, use_s0, d_state, strong): rwkv6-1.6b's
# training shape (1, 1024, 32 heads), the tail pad at S=500, chunk 16,
# strong decay, the state's cotangent
GPU_CASES = [(torch.bfloat16, 1024, 32, 64, True, False, False, False),
             (torch.bfloat16, 500, 32, 64, True, True, True, False),
             (torch.float32, 500, 32, 64, True, True, True, False),
             (torch.float32, 300, 8, 16, False, True, False, False),
             (torch.bfloat16, 1536, 8, 64, True, True, False, True),
             (torch.float32, 200, 4, 64, True, False, True, True)]


def _card_operands(case, seed=0):
    dtype, S, H, chunk, use_u, use_s0, d_state, strong = case
    x, do, ds = _operands(seed + S, 1, S, H, use_u=use_u, use_s0=use_s0,
                          d_state=d_state, strong=strong)
    t = {k: None if v is None else torch.from_numpy(v).cuda()
         for k, v in x.items()}
    for k in ("r", "k", "v"):
        t[k] = t[k].to(dtype)
    return (t, torch.from_numpy(do).cuda().to(dtype),
            None if ds is None else torch.from_numpy(ds).cuda())


def kernel_bwd(t, do, ds, chunk):
    """The forward kernel (saving its states) then the backward kernels,
    through the wrapper's own two halves."""
    args = tuple(t[k] for k in GRADS)
    _, _, states = ops._forward(*args, chunk, states=True)
    return dict(zip(GRADS, ops._backward(*args, states, do, ds, chunk)))


@gpu
@needs_cuda
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_k6_backward_kernels_against_plain(case):
    torch.backends.cuda.matmul.allow_tf32 = False
    chunk = case[3]
    t, do, ds = _card_operands(case)
    kernels.reset_counts()
    got = kernel_bwd(t, do, ds, chunk)
    again = kernel_bwd(t, do, ds, chunk)
    torch.cuda.synchronize()
    assert (ops.bwd_launches, ops.bwd_du_launches) == (2, 2 * int(case[4]))
    t32 = {k: None if v is None else v.float() for k, v in t.items()}
    want = _plain_bwd(t32, do.float(), ds, chunk)
    bound = REL if case[0] == torch.float32 else BF16_REL
    for k in GRADS:
        if t[k] is None and k != "initial_state":
            assert got[k] is None, k
            continue
        assert torch.equal(got[k], again[k]), f"{k}: not bitwise"
        assert torch.isfinite(got[k]).all(), k
        assert got[k].dtype == (t[k] if t[k] is not None
                                else want[k]).dtype, k
        rel = _rel(got[k].float().cpu(), want[k].cpu())
        assert rel <= bound, (k, rel)
        off = got[k].float().clone()
        off[..., 1::2] *= 1.01
        assert _rel(off.cpu(), want[k].cpu()) > bound, f"{k}: 1% passes"


# the bf16 design's increment, carry and tensor-core gradient pass at
# chunk 16 (one row tile, eight column groups), two sequences (the carry's
# and the chunk grid's batch index), strong decay: (B, S, H, chunk, use_u,
# use_s0, d_state, strong)
BF16_CASES = [(1, 300, 8, 16, True, True, True, False),
              (2, 45, 4, 16, False, False, False, True),
              (2, 200, 4, 64, True, True, True, True)]


@gpu
@needs_cuda
@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_k6_bf16_backward_decomposition(case):
    B, S, H, chunk, use_u, use_s0, d_state, strong = case
    x, do, ds = _operands(S + B, B, S, H, use_u=use_u, use_s0=use_s0,
                          d_state=d_state, strong=strong)
    t = {k: None if v is None else torch.from_numpy(v).cuda()
         for k, v in x.items()}
    for k in ("r", "k", "v"):
        t[k] = t[k].to(torch.bfloat16)
    do = torch.from_numpy(do).cuda().to(torch.bfloat16)
    ds = None if ds is None else torch.from_numpy(ds).cuda()
    got, again = kernel_bwd(t, do, ds, chunk), kernel_bwd(t, do, ds, chunk)
    torch.cuda.synchronize()
    t32 = {k: None if v is None else v.float() for k, v in t.items()}
    want = _plain_bwd(t32, do.float(), ds, chunk)
    for k in GRADS:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert torch.equal(got[k], again[k]), f"{k}: not bitwise"
        rel = _rel(got[k].float().cpu(), want[k].cpu())
        assert rel <= BF16_REL, (k, rel)


# the fp32 design (3xTF32: increment, carry, a gradient pass of 16 warps
# at C = 64, 8 at C = 16) at both chunks, two sequences, strong decay, S
# not a chunk multiple: (B, S, H, chunk, use_u, use_s0, d_state, strong)
F32_CASES = [(2, 300, 8, 16, True, True, True, False),
             (2, 45, 4, 16, False, False, False, True),
             (2, 200, 4, 64, True, True, True, True),
             (2, 333, 8, 64, True, False, True, False)]


@gpu
@needs_cuda
@pytest.mark.parametrize("case", F32_CASES, ids=str)
def test_k6_f32_backward_decomposition(case):
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, chunk, use_u, use_s0, d_state, strong = case
    x, do, ds = _operands(S + B + 1, B, S, H, use_u=use_u, use_s0=use_s0,
                          d_state=d_state, strong=strong)
    t = {k: None if v is None else torch.from_numpy(v).cuda()
         for k, v in x.items()}
    do = torch.from_numpy(do).cuda()
    ds = None if ds is None else torch.from_numpy(ds).cuda()
    before = ops.f32_bwd_launches
    got, again = kernel_bwd(t, do, ds, chunk), kernel_bwd(t, do, ds, chunk)
    torch.cuda.synchronize()
    assert ops.f32_bwd_launches == before + 2
    want = _plain_bwd(t, do, ds, chunk)
    for k in GRADS:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert torch.equal(got[k], again[k]), f"{k}: not bitwise"
        assert got[k].dtype == torch.float32 and torch.isfinite(got[k]).all()
        rel = _rel(got[k].cpu(), want[k].cpu())
        assert rel <= REL, (k, rel)


@gpu
@needs_cuda
@pytest.mark.parametrize("chunk", [16, 64])
def test_k6_f32_autograd_never_calls_the_plain_versions(chunk, monkeypatch):
    """fp32 through the autograd wrapper, two sequences, S not a chunk
    multiple, strong decay, u and an initial state: the gradients come
    from the kernels alone and agree with the plain backward."""
    def refuse(*a, **kw):
        raise AssertionError("a plain K6 version ran on the card")

    x, do, _ = _operands(chunk, 2, 3 * chunk + 5, 4, use_u=True,
                         use_s0=True, d_state=False, strong=True)
    t = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
    do = torch.from_numpy(do).cuda()
    want = _plain_bwd(t, do, None, chunk)
    for mod in (ops, ref):
        monkeypatch.setattr(mod, "decay_attention_chunked", refuse)
    monkeypatch.setattr(ref, "decay_attention_chunked_bwd", refuse)
    leaves = [t[k].clone().requires_grad_() for k in GRADS]
    kernels.reset_counts()
    o, _ = ops.linear_attn_bshd(*leaves, chunk=chunk)
    grads = torch.autograd.grad((o * do).sum(), leaves)
    assert (ops.grad_launches, ops.bwd_launches,
            ops.bwd_du_launches) == (1, 1, 1)
    for k, g in zip(GRADS, grads):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert _rel(g.cpu(), want[k].cpu()) <= REL, k


@gpu
@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_autograd_never_calls_the_plain_versions(dtype, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a plain K6 version ran on the card")

    for mod in (ops, ref):
        monkeypatch.setattr(mod, "decay_attention_chunked", refuse)
    monkeypatch.setattr(ref, "decay_attention_chunked_bwd", refuse)
    t, do, _ = _card_operands((dtype, 300, 4, 64, True, True, False, False))
    leaves = [None if t[k] is None else t[k].clone().requires_grad_()
              for k in GRADS]
    kernels.reset_counts()
    o, _ = ops.linear_attn_bshd(*leaves, chunk=64)
    grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
    assert (ops.grad_launches, ops.bwd_launches,
            ops.bwd_du_launches) == (1, 1, 1)
    for g, x in zip(grads, leaves):
        assert g.dtype == x.dtype and torch.isfinite(g).all()
