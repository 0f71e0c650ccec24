"""The prefill kernel K3 at two head dims: q/k of one width and v of
another, as deepseek-v2-lite's MLA prefill runs it (nope 128 + rope 64 for
q/k, 128 for v).

On the CPU the wrapper ``flash_attention_bshd`` runs the plain version,
which takes any widths; here it is held against JAX's
``blocked_attention`` at ``atol = rtol = 2e-5`` (fp32, the two sides sum
in different orders).  ``_mla_prefill_attention`` now calls K3 at those
widths unpadded; it equals the zero-padded call it replaces within 1e-6.
The wrapper's checks take each build's (Dqk, Dv) pair in both dtypes (in
fp32 also the reduced MLA widths (48, 32)), pad nothing and refuse every
other width.  The card's cases are ``gpu``-marked and skip without one:

    python -m pytest --noconftest -m gpu tests/test_torch_k3_widths.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _mla(seed, S, H, dqk=192, dv=128, dtype=np.float32):
    rs = np.random.default_rng(seed)
    q, k = (rs.standard_normal((1, S, H, dqk), dtype=np.float32)
            for _ in range(2))
    v = rs.standard_normal((1, S, H, dv), dtype=np.float32)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_wrapper_takes_mla_widths_and_matches_jax(window, H, Hkv):
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention

    S, scale = 40, 1.0 / math.sqrt(192)
    q, _, _ = _mla(window + Hkv, S, H)
    _, k, v = _mla(window + Hkv + 1, S, Hkv)
    pos = np.arange(S)
    ref = blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos)[None], jnp.asarray(pos),
                            window=window, causal=True, scale=scale)
    before = ops.launches
    out = ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), window=window,
                                   scale=scale)
    assert ops.launches == before
    assert out.shape == (1, S, H, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S", [37, 96])
def test_mla_prefill_unpadded_equals_padded(S):
    q, k, v = (torch.from_numpy(t) for t in _mla(S, S, 4))
    scale = 1.0 / math.sqrt(192)
    pos = torch.arange(S)
    ai = attention.AttnInputs(q_pos=pos[None], cache_k=None, cache_v=None,
                              cache_len=None, tree_mask=None, window=0,
                              causal=True)
    out = attention._mla_prefill_attention(q, k, v, ai, scale)
    pad = lambda t: F.pad(t, (0, 256 - t.shape[-1]))
    padded = ops.flash_attention_bshd(pad(q), pad(k), pad(v),
                                      scale=scale)[..., :128]
    torch.testing.assert_close(out, padded, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", [(192, 128), (80, 80), (128, 128),
                                  (256, 256), (64, 64)])
def test_cuda_checks_take_each_build_unpadded(dims, dtype):
    """Every (Dqk, Dv) build passes the CUDA checks in both dtypes, and the
    launch gets the operands at their own widths: the fp32 wrapper pads
    (192, 128) to nothing (it padded to 256 before the fp32 builds were
    redesigned), so the output has Dv columns."""
    mk = lambda d: torch.zeros((1, 8, 2, d), dtype=dtype)
    q, k, v = mk(dims[0]), mk(dims[0]), mk(dims[1])
    ops._check_cuda(q, k, v)
    builds = (ops._k.F32_DIMS if dtype == torch.float32 else ops._k.DIMS)
    assert dims in builds and not hasattr(ops, "_f32_dim")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", [(96, 64), (192, 192), (128, 64),
                                  (320, 128), (32, 32), (256, 128)])
def test_cuda_checks_refuse_a_width_without_a_build(dims, dtype):
    """A (Dqk, Dv) without a build of its own is refused in either dtype:
    fp32 no longer pads (96, 64) to 128 or (256, 128) to 256."""
    mk = lambda d: torch.zeros((1, 8, 2, d), dtype=dtype)
    with pytest.raises(ValueError, match="head dims"):
        ops._check_cuda(mk(dims[0]), mk(dims[0]), mk(dims[1]))


def test_fp32_builds_add_the_reduced_mla_widths_only():
    """fp32 builds the bf16 builds' widths and deepseek-v2-lite's reduced
    MLA widths (48, 32), which the narrow fp32 runs on the card reach;
    bf16 refuses (48, 32)."""
    from repro_torch.configs import get_config

    m = get_config("deepseek-v2-lite-16b").reduced().mla
    reduced = (m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim)
    assert set(ops._k.F32_DIMS) - set(ops._k.DIMS) == {reduced} == {(48, 32)}
    mk = lambda d, dt: torch.zeros((1, 8, 2, d), dtype=dt)
    ops._check_cuda(mk(48, torch.float32), mk(48, torch.float32),
                    mk(32, torch.float32))
    with pytest.raises(ValueError, match="head dims"):
        ops._check_cuda(mk(48, torch.bfloat16), mk(48, torch.bfloat16),
                        mk(32, torch.bfloat16))


def test_cuda_checks_refuse_a_misaligned_operand():
    """The kernels read 16 bytes a thread: an operand view that starts off
    a 16-byte boundary is refused rather than read misaligned."""
    buf = torch.zeros(1 * 8 * 2 * 64 + 1)
    q = buf[1:].view(1, 8, 2, 64)
    k = torch.zeros((1, 8, 2, 64))
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_cuda(q, k, k.clone())


def test_wrapper_rejects_v_of_another_length():
    q, k, v = (torch.from_numpy(t) for t in _mla(0, 16, 2))
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(q, k, v[:, :8])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S", [37, 300])
def test_cuda_kernel_at_mla_widths(dtype, tol, S):
    """K3 at (192, 128) on the card, unpadded in both dtypes, against its
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to("cuda", dt) for t in _mla(S, S, 16))
    scale = 1.0 / math.sqrt(192)
    before = ops.launches
    out = ops.flash_attention_bshd(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert ops.launches == before + 1 and out.shape[-1] == 128
    ref = flash_attention_plain(q, k, v, scale=scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(64, 64), (80, 80), (128, 128),
                                  (256, 256), (192, 128), (48, 32)])
def test_cuda_fp32_build_at_each_width(dims):
    """Each fp32 build (3xTF32 on the tensor cores) against its plain
    version within 1e-4, G = 4, causal with a window that crosses tiles,
    two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dqk, dv = dims
    rs = np.random.default_rng(dqk + dv)
    mk = lambda h, d: torch.from_numpy(
        rs.standard_normal((2, 333, h, d), dtype=np.float32)).cuda()
    q, k, v = mk(8, dqk), mk(2, dqk), mk(2, dv)
    out = ops.flash_attention_bshd(q, k, v, window=100)
    again = ops.flash_attention_bshd(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and out.shape[-1] == dv
    ref = flash_attention_plain(q, k, v, window=100)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
