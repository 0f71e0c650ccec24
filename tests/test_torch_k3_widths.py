"""The prefill kernel K3 at two head dims: q/k of one width and v of
another, as deepseek-v2-lite's MLA prefill runs it (nope 128 + rope 64 for
q/k, 128 for v).

On the CPU the wrapper ``flash_attention_bshd`` runs the plain version,
which takes any widths; here it is held against JAX's
``blocked_attention`` at ``atol = rtol = 2e-5`` (fp32, the two sides sum
in different orders).  ``_mla_prefill_attention`` now calls K3 at those
widths unpadded; it equals the zero-padded call it replaces within 1e-6.
The wrapper's checks take the bf16 builds' (Dqk, Dv) pairs and, for fp32,
pad to the CUDA-core body's one head dim.  The card's case is
``gpu``-marked and skips without one:

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


def test_cuda_checks_take_the_bf16_builds_and_pad_fp32():
    mk = lambda d, dtype: torch.zeros((1, 8, 2, d), dtype=dtype)
    for dims in ((192, 128), (128, 128), (256, 256), (64, 64)):
        ops._check_cuda(mk(dims[0], torch.bfloat16),
                        mk(dims[0], torch.bfloat16),
                        mk(dims[1], torch.bfloat16))
    for dims in ((96, 64), (192, 192), (128, 64)):
        with pytest.raises(ValueError):
            ops._check_cuda(mk(dims[0], torch.bfloat16),
                            mk(dims[0], torch.bfloat16),
                            mk(dims[1], torch.bfloat16))
    ops._check_cuda(mk(192, torch.float32), mk(192, torch.float32),
                    mk(128, torch.float32))
    assert ops._f32_dim(192, 128) == 256 and ops._f32_dim(64, 32) == 64
    with pytest.raises(ValueError):
        ops._check_cuda(mk(320, torch.float32), mk(320, torch.float32),
                        mk(128, torch.float32))


def test_wrapper_rejects_v_of_another_length():
    q, k, v = (torch.from_numpy(t) for t in _mla(0, 16, 2))
    with pytest.raises(ValueError):
        ops.flash_attention_bshd(q, k, v[:, :8])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S", [37, 300])
def test_cuda_kernel_at_mla_widths(dtype, tol, S):
    """K3 at (192, 128) on the card (bf16 unpadded; fp32 through the
    wrapper's padding) against its plain version."""
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
