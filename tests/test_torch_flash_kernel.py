"""The port's prefill attention (K3) against the JAX reference.

On the CPU the port's wrapper ``flash_attention_bshd`` runs the kernel's
plain PyTorch version (``blocked_attention`` with ``q_pos = kv_pos =
arange(S)``); these tests hold it against the JAX Pallas kernel
``flash_attention`` (interpret mode) and the JAX oracle
``flash_attention_ref``: causal and bidirectional, windows 0 and 24, GQA
with G > 1, an S with no divisor >= 8 (the JAX kernel then pads and
masks its tail), and head dim 256 over one kv head (gemma3-1b's heads).
Tolerance ``atol = rtol = 1e-4`` (fp32, the two sides sum in different
orders).  The CUDA kernel against the plain version is the
``gpu``-marked case; it skips without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_plain)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _case(seed, B, S, Hq, Hkv, D):
    """Random fp32 q, k, v from a numpy seed in the MODEL layout."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    return r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D)


def _port(q, k, v, **kw):
    return ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw).numpy()


def _jax(name, q, k, v, *, causal=True, window=0, bq=None, bk=None):
    """The JAX kernel (``"kernel"``, interpret mode) or oracle (``"ref"``)
    in its kernel layout; returns the model layout."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.kernel import flash_attention
    from repro.kernels.flash_attention.ref import flash_attention_ref

    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    if name == "kernel":
        o = flash_attention(tr(q), tr(k), tr(v), causal=causal, window=window,
                            bq=bq, bk=bk, interpret=True)
    else:
        o = flash_attention_ref(tr(q), tr(k), tr(v), causal=causal,
                                window=window)
    return np.asarray(o).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (6, 2)])
def test_plain_matches_jax_kernel_and_ref(window, Hq, Hkv):
    q, k, v = _case(window + Hkv, 2, 64, Hq, Hkv, 64)
    out = _port(q, k, v, window=window)
    np.testing.assert_allclose(
        out, _jax("kernel", q, k, v, window=window, bq=32, bk=16), **TOL)
    np.testing.assert_allclose(out, _jax("ref", q, k, v, window=window),
                               **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_ragged_S_without_a_divisor(window):
    """S = 37 (prime) against 16-wide JAX blocks: the JAX kernel pads to 48
    and masks the tail (``s_real``); the port takes S as it is."""
    q, k, v = _case(1, 1, 37, 4, 2, 64)
    out = _port(q, k, v, window=window)
    np.testing.assert_allclose(
        out, _jax("kernel", q, k, v, window=window, bq=16, bk=16), **TOL)
    np.testing.assert_allclose(out, _jax("ref", q, k, v, window=window),
                               **TOL)


def test_bidirectional():
    q, k, v = _case(2, 1, 40, 4, 2, 64)
    out = _port(q, k, v, causal=False)
    np.testing.assert_allclose(
        out, _jax("kernel", q, k, v, causal=False, bq=8, bk=8), **TOL)
    np.testing.assert_allclose(out, _jax("ref", q, k, v, causal=False),
                               **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_head_dim_256_one_kv_head(window):
    """gemma3-1b's heads: 4 query heads over 1 kv head at head dim 256."""
    q, k, v = _case(3, 1, 48, 4, 1, 256)
    out = _port(q, k, v, window=window)
    np.testing.assert_allclose(
        out, _jax("kernel", q, k, v, window=window, bq=16, bk=16), **TOL)
    np.testing.assert_allclose(out, _jax("ref", q, k, v, window=window),
                               **TOL)


def test_plain_is_blocked_attention_over_arange():
    """The CPU path keeps the numbers of the port's full-seq attention
    before K3: ``blocked_attention`` at positions 0..S-1, bit for bit."""
    from repro_torch.models.layers import blocked_attention

    q, k, v = (torch.from_numpy(a) for a in _case(4, 2, 40, 4, 2, 64))
    pos = torch.arange(40)
    np.testing.assert_array_equal(
        ops.flash_attention_bshd(q, k, v, window=16).numpy(),
        blocked_attention(q, k, v, pos[None].expand(2, 40), pos,
                          window=16).numpy())


def test_wrapper_rejects_mismatched_kv():
    q, k, v = _case(5, 1, 16, 4, 2, 64)
    with pytest.raises(ValueError, match="k/v"):
        _port(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError, match="group"):
        _port(q[:, :, :3], k, v)


def test_cpu_path_launches_no_kernel():
    before = ops.launches
    _port(*_case(6, 1, 16, 4, 2, 64))
    assert ops.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("heads", [(4, 1, 256), (24, 8, 128), (32, 32, 64)])
@pytest.mark.parametrize("S,window", [(37, 0), (300, 512), (1536, 512),
                                      (1536, 0)])
def test_cuda_kernel_matches_plain(dtype, tol, heads, S, window):
    """The hand-written kernel against its plain version on the card, at
    gemma3-1b's, minitron-4b's and zamba2-1.2b's head shapes (fp32 on the
    tensor cores in 3xTF32, within the same 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    Hq, Hkv, D = heads
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to("cuda", dt)
               for a in _case(7, 1, S, Hq, Hkv, D))
    before = ops.launches
    out = ops.flash_attention_bshd(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
