"""The port's chunked decay linear attention (K6) against the JAX
reference.

On the CPU the port's wrapper ``linear_attn_bshd`` runs the kernel's
plain version; these tests hold it against the JAX Pallas kernel
(``linear_attn_bshd``, interpret mode) and the JAX sequential oracle
``linear_attn_ref`` over the sweep of ``tests/test_kernels.py`` (shapes,
u on and off, strong decay, S not a chunk multiple), with the same
relative bound (max |o - ref| / max |ref| below 1e-4; 1e-3 for strong
decay, as there).  Then the wrapper's validation, and that the CPU path
launches nothing.  The CUDA kernel against the plain version is the
``gpu``-marked cases (the fp32 build, 3xTF32, also at chunk 16, two
sequences and a chunk of pure padding); they skip without a card.  The
JAX side is imported inside the helper that runs it, so the ``gpu`` case
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_linear_attn_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.linear_attn_chunk import ops  # noqa: E402
from repro_torch.kernels.linear_attn_chunk.ref import (  # noqa: E402
    decay_attention_chunked, linear_attn_ref)

torch.set_num_threads(2)


def _case(seed, B, S, H, dk, dv, *, use_u=True, strong=False):
    """Random fp32 inputs from a numpy seed, in the MODEL layout."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    w = (-np.exp(r(B, S, H, dk) * 1.5 + 1.0) if strong
         else -np.exp(r(B, S, H, dk) * 0.5)).astype(np.float32)
    return dict(r=r(B, S, H, dk), k=r(B, S, H, dk), v=r(B, S, H, dv), w=w,
                u=r(H, dk) * 0.1 if use_u else None)


def _port(c, chunk):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in c.items()}
    o, st = ops.linear_attn_bshd(t["r"], t["k"], t["v"], t["w"], t["u"],
                                 chunk=chunk)
    return o.numpy(), st


def _jax(name, c, chunk):
    """The JAX kernel wrapper (``"kernel"``, interpret mode) in the model
    layout, or the sequential oracle (``"ref"``) in its kernel layout;
    returns the model layout."""
    import jax.numpy as jnp
    from repro.kernels.linear_attn_chunk.ops import linear_attn_bshd
    from repro.kernels.linear_attn_chunk.ref import \
        linear_attn_ref as jax_ref

    j = {k: None if v is None else jnp.asarray(v) for k, v in c.items()}
    if name == "kernel":
        return np.asarray(linear_attn_bshd(j["r"], j["k"], j["v"], j["w"],
                                           j["u"], chunk=chunk,
                                           interpret=True))
    tr = lambda t: t.transpose(0, 2, 1, 3)
    o = jax_ref(tr(j["r"]), tr(j["k"]), tr(j["v"]), tr(j["w"]), j["u"])
    return np.asarray(o).transpose(0, 2, 1, 3)


def _rel(a, ref):
    return float(np.max(np.abs(a - ref))) / (float(np.max(np.abs(ref)))
                                             + 1e-6)


# the sweep of tests/test_kernels.py (kernel layout B, H, S, dk, dv, chunk)
SWEEP = [(1, 2, 128, 32, 32, 32), (2, 3, 256, 64, 64, 64),
         (1, 2, 256, 32, 64, 64)]


@pytest.mark.parametrize("B,H,S,dk,dv,chunk", SWEEP)
@pytest.mark.parametrize("use_u", [True, False])
def test_plain_matches_jax_kernel_and_ref(B, H, S, dk, dv, chunk, use_u):
    c = _case(S + dk + use_u, B, S, H, dk, dv, use_u=use_u)
    out, _ = _port(c, chunk)
    for name in ("kernel", "ref"):
        assert _rel(out, _jax(name, c, chunk)) < 1e-4, name


def test_strong_decay():
    """Strong decays are the numerically dangerous regime: the pairwise
    intra-chunk form keeps every exponent at or below zero."""
    c = _case(20, 1, 128, 2, 32, 32, use_u=False, strong=True)
    out, st = _port(c, 64)
    assert np.isfinite(out).all() and torch.isfinite(st).all()
    for name in ("kernel", "ref"):
        assert _rel(out, _jax(name, c, 64)) < 1e-3, name


def test_s_not_a_chunk_multiple():
    """S = 100 with chunk 64: padded with k = 0, w = 0 (exact)."""
    c = _case(21, 2, 100, 2, 32, 32, use_u=False)
    out, _ = _port(c, 64)
    assert out.shape == (2, 100, 2, 32)
    np.testing.assert_allclose(out, _jax("ref", c, 64), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out, _jax("kernel", c, 64), atol=1e-4,
                               rtol=1e-3)


def test_port_oracle_matches_jax_oracle():
    c = _case(22, 1, 40, 2, 16, 16)
    tr = lambda a: torch.from_numpy(a).transpose(1, 2)
    o = linear_attn_ref(tr(c["r"]), tr(c["k"]), tr(c["v"]), tr(c["w"]),
                        torch.from_numpy(c["u"])).transpose(1, 2)
    np.testing.assert_allclose(o.numpy(), _jax("ref", c, 16), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# validation and dispatch
# ---------------------------------------------------------------------------


def _tensors(B=1, S=8, H=2, dk=64, dv=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g).to(dtype)
    return [r(B, S, H, dk), r(B, S, H, dk), r(B, S, H, dv),
            -torch.rand((B, S, H, dk), generator=g), None, None]


@pytest.mark.parametrize("bad,exc,match", [
    (lambda a: a.__setitem__(3, a[3][..., :1]), NotImplementedError,
     "scalar"),
    (lambda a: a.__setitem__(0, a[0][:, :4]), ValueError, "r and w_log"),
    (lambda a: a.__setitem__(2, a[2][:, :4]), ValueError, "v must be"),
    (lambda a: a.__setitem__(4, torch.zeros(3, 64)), ValueError, "u must"),
    (lambda a: a.__setitem__(5, torch.zeros(1, 2, 64, 32)), ValueError,
     "initial_state"),
])
def test_wrapper_rejects_bad_operands(bad, exc, match):
    args = _tensors()
    bad(args)
    with pytest.raises(exc, match=match):
        ops.linear_attn_bshd(*args, chunk=16)


@pytest.mark.parametrize("change,match", [
    (lambda a: a.__setitem__(2, a[2].double()), "one dtype|unsupported"),
    (lambda a: a.__setitem__(3, a[3].to(torch.bfloat16)), "float32"),
    (lambda a: a.__setitem__(1, a[1].transpose(1, 2).contiguous()
                             .transpose(1, 2)), "contiguous"),
])
def test_kernel_checks_reject_what_it_does_not_take(change, match):
    """What the CUDA path refuses before launching (checked here on CPU
    tensors: the checks do not touch the device)."""
    args = _tensors()
    change(args)
    with pytest.raises(ValueError, match=match):
        ops.check_cuda_operands(*args, 64)


def test_kernel_checks_head_dim_and_chunk():
    with pytest.raises(ValueError, match="dk = dv"):
        ops.check_cuda_operands(*_tensors(dk=32, dv=32), 64)
    with pytest.raises(ValueError, match="chunk"):
        ops.check_cuda_operands(*_tensors(), 48)
    ops.check_cuda_operands(*_tensors(dtype=torch.bfloat16), 64)


def test_cpu_path_launches_no_kernel():
    before = ops.launches
    o, st = ops.linear_attn_bshd(*_tensors(), chunk=16)
    assert ops.launches == before
    assert o.shape == (1, 8, 2, 64) and st.dtype == torch.float32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
def test_cuda_kernel_matches_plain(dtype, tol, S, init, strong):
    """The hand-written kernel (chunk pass and scan) against its plain
    version on the card at rwkv6-1.6b head shapes (32 heads of 64, chunk
    64), also in the strong-decay regime (fp32 there at this file's
    strong-decay bound, 1e-3: at log-decays of -3000 a step the cumulative
    log-decay reaches 1e5, whose fp32 rounding moves a pairwise decay
    factor by ~1e-3 in either form): output and final state; and a
    length-masked pad tail bitwise equal to the exact length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if strong:
        tol = max(tol, 1e-3)
    c = _case(S + strong, 1, S + 20, 32, 64, 64, strong=strong)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    r, k, v = (t[n].to(dt) for n in "rkv")
    s0 = (torch.randn((1, 32, 64, 64), device="cuda") * 0.1 if init
          else None)
    real = [x[:, :S].contiguous() for x in (r, k, v, t["w"])]
    before = (ops.launches, ops.scan_launches)
    o, st = ops.linear_attn_bshd(*real, t["u"], s0, chunk=64)
    torch.cuda.synchronize()
    assert (ops.launches, ops.scan_launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert torch.isfinite(o.float()).all() and torch.isfinite(st).all()
    ro, rst = decay_attention_chunked(*real, t["u"], s0, chunk=64)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, rst, atol=tol, rtol=tol)
    keep = torch.arange(S + 20, device="cuda")[None, :, None, None] < S
    o_m, st_m = ops.linear_attn_bshd(r, torch.where(keep, k, 0.0), v,
                                     torch.where(keep, t["w"], 0.0), t["u"],
                                     s0, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(o_m[:, :S], o) and torch.equal(st_m, st)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
def test_cuda_f32_kernel_chunks_batch_and_padding(chunk, strong):
    """The fp32 build (every product in 3xTF32 on the tensor cores) at
    both chunks, two sequences, S not a chunk multiple, with u and an
    initial state, also under strong decay (log-decay down to -20 a
    step, chip_smoke.py's regime): output and final state within 1e-4 of
    the plain version; two identical calls bitwise equal; the sequence
    padded past its last chunk with a whole chunk of k = w = 0 (r and v
    random) gives the same outputs and leaves the final state bit for
    bit; each call counted in ``f32_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, S = 2, 8, 5 * chunk + 7
    pad = -S % chunk + chunk                      # the tail, then a chunk
    rs = np.random.default_rng(chunk + strong)
    n = lambda *s_: rs.standard_normal(s_, dtype=np.float32)
    w = (np.maximum(-np.exp(n(B, S + pad, H, 64) * 1.5 + 1.0), -20.0)
         if strong else -np.exp(n(B, S + pad, H, 64) * 0.5))
    t = {name: torch.from_numpy(x.astype(np.float32)).cuda() for name, x in
         (("r", n(B, S + pad, H, 64)), ("k", n(B, S + pad, H, 64)),
          ("v", n(B, S + pad, H, 64)), ("w", w), ("u", n(H, 64) * 0.1),
          ("s0", n(B, H, 64, 64) * 0.1))}
    real = [t[x][:, :S].contiguous() for x in "rkvw"]
    before = ops.f32_launches
    o, st = ops.linear_attn_bshd(*real, t["u"], t["s0"], chunk=chunk)
    o2, st2 = ops.linear_attn_bshd(*real, t["u"], t["s0"], chunk=chunk)
    keep = torch.arange(S + pad, device="cuda")[None, :, None, None] < S
    o_p, st_p = ops.linear_attn_bshd(
        t["r"], torch.where(keep, t["k"], 0.0), t["v"],
        torch.where(keep, t["w"], 0.0), t["u"], t["s0"], chunk=chunk)
    torch.cuda.synchronize()
    assert ops.f32_launches == before + 3
    assert torch.equal(o, o2) and torch.equal(st, st2)
    assert torch.equal(o_p[:, :S], o) and torch.equal(st_p, st)
    ro, rst = decay_attention_chunked(*real, t["u"], t["s0"], chunk=chunk)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    torch.testing.assert_close(o, ro, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, rst, atol=1e-4, rtol=1e-4)
