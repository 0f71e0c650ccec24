"""K3's chunk form (a query offset and ``kv_valid_len``) and the chunked-
prefill continuation of the attention modules, against the JAX reference.

JAX runs a chunk of a resumable prefill through jnp ``blocked_attention``
with ``q_pos = start + arange(C)``, ``kv_pos = arange(S)`` over the cache
view and ``kv_valid_len = start + C`` (``repro/models/attention.py::
_prefill_continuation``).  On the CPU the port's wrapper
``flash_attention_bshd(..., q_off=, kv_valid_len=)`` runs the kernel's
plain version, the port's ``blocked_attention`` with those positions:

* the wrapper against JAX ``blocked_attention``: query offsets 0, mid and
  late, windows 0 and 24, GQA, MLA's (192, 128) widths with its scale,
  per-row offsets over B = 2 (atol = rtol = 1e-5, fp32);
* a chunk's rows against the same rows of a whole prefill (1e-6), and
  huge finite values past ``kv_valid_len`` change no bit;
* ``gqa_fwd`` and ``mla_fwd`` in their chunk branch (``AttnInputs.
  prefill``) against JAX's, dense and paged: output and written cache
  (1e-5);
* the wrapper's validation, and no launch on the CPU.

The CUDA kernel's chunk form against its plain version, bitwise
unchanged by poison (NaN, inf, +-1e4) past ``kv_valid_len``, and its
chunk rows bitwise equal to a whole prefill's at offsets that are
multiples of 64 (the query tile, in bf16 and fp32: every fp32 build at
64 and 192 too) are the ``gpu``-marked cases; they skip without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_k3_chunk.py
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_plain)
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rs, *shape):
    return rs.standard_normal(shape, dtype=np.float32)


def _jax_chunk(q, k, v, q_off, kvl, *, window=0, scale=None):
    """JAX ``blocked_attention`` as its chunk continuation calls it."""
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention as jax_blocked_attention

    B, C = q.shape[:2]
    q_pos = np.asarray(q_off, np.int32).reshape(-1, 1) + np.arange(C)
    out = jax_blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.broadcast_to(q_pos, (B, C))),
        jnp.arange(k.shape[1]), window=window, causal=True, scale=scale,
        kv_valid_len=jnp.asarray(np.asarray(kvl, np.int32)))
    return np.asarray(out)


def _port_chunk(q, k, v, q_off, kvl, **kw):
    t = torch.from_numpy
    q_off = q_off if isinstance(q_off, int) else t(np.asarray(q_off))
    return ops.flash_attention_bshd(
        t(q), t(k), t(v), q_off=q_off,
        kv_valid_len=t(np.asarray(kvl, np.int32)), **kw).numpy()


# ---------------------------------------------------------------------------
# the chunk form's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q_off", [0, 24, 72])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (6, 2)])
def test_chunk_matches_jax_blocked_attention(q_off, window, Hq, Hkv):
    """C = 24 rows at ``q_off`` over a view of 128 keys, valid to
    ``q_off + C``; the view past it holds finite garbage."""
    rs = np.random.default_rng(q_off + window + Hkv)
    C, S, D = 24, 128, 64
    q, k, v = _rand(rs, 1, C, Hq, D), _rand(rs, 1, S, Hkv, D), \
        _rand(rs, 1, S, Hkv, D)
    kvl = [q_off + C]
    np.testing.assert_allclose(
        _port_chunk(q, k, v, q_off, kvl, window=window),
        _jax_chunk(q, k, v, [q_off], kvl, window=window), **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_chunk_at_mla_widths_matches_jax(window):
    """deepseek's MLA prefill widths: q/k 192, v 128, G = 1, scale
    1/sqrt(192)."""
    rs = np.random.default_rng(5 + window)
    C, S, H = 16, 96, 4
    q, k, v = _rand(rs, 1, C, H, 192), _rand(rs, 1, S, H, 192), \
        _rand(rs, 1, S, H, 128)
    scale = 1.0 / math.sqrt(192)
    out = _port_chunk(q, k, v, 40, [56], window=window, scale=scale)
    assert out.shape == (1, C, H, 128)
    np.testing.assert_allclose(
        out, _jax_chunk(q, k, v, [40], [56], window=window, scale=scale),
        **TOL)


def test_per_row_offsets_match_jax():
    """Two rows at their own offsets and valid lengths (the kernel reads
    both per row)."""
    rs = np.random.default_rng(11)
    C, S = 12, 80
    q, k, v = _rand(rs, 2, C, 4, 64), _rand(rs, 2, S, 2, 64), \
        _rand(rs, 2, S, 2, 64)
    np.testing.assert_allclose(
        _port_chunk(q, k, v, np.array([8, 50], np.int32), [20, 62],
                    window=16),
        _jax_chunk(q, k, v, [8, 50], [20, 62], window=16), **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_chunk_rows_equal_whole_prefill_rows(window):
    """A chunk's rows over the whole view are the same rows of the whole
    prefill of ``q_off + C`` tokens: the view's tail past ``kv_valid_len``
    (here huge finite values) is masked."""
    rs = np.random.default_rng(21)
    q_off, C, S = 48, 32, 128
    q, k, v = _rand(rs, 1, S, 4, 64), _rand(rs, 1, S, 2, 64), \
        _rand(rs, 1, S, 2, 64)
    t = torch.from_numpy
    n = q_off + C
    whole = ops.flash_attention_bshd(
        t(q[:, :n].copy()), t(k[:, :n].copy()), t(v[:, :n].copy()),
        window=window).numpy()
    kp, vp = k.copy(), v.copy()
    kp[:, n:], vp[:, n:] = 1e4, -1e4
    chunk = _port_chunk(q[:, q_off:n].copy(), kp, vp, q_off, [n],
                        window=window)
    np.testing.assert_allclose(chunk, whole[:, q_off:], atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(
        chunk, _port_chunk(q[:, q_off:n].copy(), k, v, q_off, [n],
                           window=window))


def test_whole_prefill_form_is_unchanged():
    """Without ``kv_valid_len`` the wrapper is the whole prefill, bit for
    bit the plain version at offset 0."""
    rs = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rs, 2, 40, h, 64)) for h in (4, 2, 2))
    np.testing.assert_array_equal(
        ops.flash_attention_bshd(q, k, v, window=16).numpy(),
        flash_attention_plain(q, k, v, window=16).numpy())


def test_wrapper_checks_the_chunk_operands():
    rs = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_rand(rs, 1, n, 2, 64)) for n in (8, 32, 32))
    with pytest.raises(ValueError, match="kv_valid_len"):
        ops.flash_attention_bshd(q, k, v, q_off=8)
    with pytest.raises(ValueError, match="k/v"):
        ops.flash_attention_bshd(q, k, v)      # whole prefill: Skv == Sq
    with pytest.raises(ValueError, match="kv_valid_len"):
        ops.flash_attention_bshd(q, k, v, q_off=8,
                                 kv_valid_len=torch.tensor([16, 16]))
    with pytest.raises(ValueError, match="q_off"):
        ops.flash_attention_bshd(q, k, v, q_off=torch.tensor([8.0]),
                                 kv_valid_len=torch.tensor([16]))


def test_cpu_chunk_launches_no_kernel():
    rs = np.random.default_rng(7)
    before = (ops.launches, ops.chunk_launches)
    _port_chunk(_rand(rs, 1, 8, 2, 64), _rand(rs, 1, 32, 2, 64),
                _rand(rs, 1, 32, 2, 64), 8, [16])
    assert (ops.launches, ops.chunk_launches) == before


# ---------------------------------------------------------------------------
# the attention modules' chunk continuation
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    from repro.configs import get_config as jax_get_config

    return [dataclasses.replace(get(arch).reduced(), dtype="float32", **kw)
            for get in (jax_get_config, get_config)]


def _attn_params(rs, names_shapes):
    return {n: _rand(rs, *s) * 0.1 for n, s in names_shapes.items()}


def _continuation(fwd: str, jcfg, cfg, p, x, view_k, view_v, start: int,
                  window: int, table=None):
    """Run one chunk at ``start`` through JAX's and the port's ``fwd``
    (``"gqa_fwd"`` or ``"mla_fwd"``) in its chunk branch.  Returns ((jax
    out, k, v), (port out, k, v)) as numpy."""
    import jax.numpy as jnp
    from repro.models import attention as jax_attention

    fwd_jax, fwd_port = getattr(jax_attention, fwd), getattr(attention, fwd)
    B, C = x.shape[:2]
    pos = np.broadcast_to(start + np.arange(C, dtype=np.int32), (B, C))
    lens = np.full((B,), start, np.int32)
    jai = jax_attention.AttnInputs(
        q_pos=jnp.asarray(pos), cache_k=jnp.asarray(view_k),
        cache_v=jnp.asarray(view_v), cache_len=jnp.asarray(lens),
        tree_mask=None, window=window, causal=True,
        block_table=None if table is None else jnp.asarray(table),
        prefill=True)
    jo = fwd_jax({n: jnp.asarray(a) for n, a in p.items()}, jcfg,
                 jnp.asarray(x), jai)
    t = torch.from_numpy
    ck, cv = t(view_k.copy()), t(view_v.copy())
    ai = attention.AttnInputs(
        q_pos=t(pos.copy()).long(), cache_k=ck, cache_v=cv,
        cache_len=t(lens), tree_mask=None, window=window, causal=True,
        block_table=None if table is None else t(table), prefill=True)
    po = fwd_port({n: t(a) for n, a in p.items()}, cfg, t(x), ai)
    assert po[1] is ck and po[2] is cv, "the cache is written in place"
    return ([np.asarray(a) for a in jo], [a.numpy() for a in po])


def _paged_layout(rs, shape_tail, lens_blocks: int, bs: int = 8):
    """A pool (N, bs, ...) and one slot's table row that scatters its
    logical blocks over it, NULL (0) past ``lens_blocks``."""
    M = 8
    table = np.zeros((1, M), np.int32)
    table[0, :lens_blocks] = rs.permutation(np.arange(1, 12))[:lens_blocks]
    pool = _rand(rs, 12, bs, *shape_tail)
    return pool, table


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("window", [0, 16])
def test_gqa_chunk_branch_matches_jax(paged, window):
    jcfg, cfg = _cfgs("minitron-4b")
    rs = np.random.default_rng(30 + window + paged)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    p = _attn_params(rs, {"wq": (d, hq * hd), "wk": (d, hkv * hd),
                          "wv": (d, hkv * hd), "wo": (hq * hd, d)})
    start, C = 24, 16
    x = _rand(rs, 1, C, d)
    if paged:
        ck, table = _paged_layout(rs, (hkv, hd), 6)
        cv = _rand(rs, *ck.shape)
    else:
        ck, cv, table = _rand(rs, 1, 64, hkv, hd), _rand(rs, 1, 64, hkv, hd), \
            None
    jo, po = _continuation("gqa_fwd", jcfg, cfg, p, x, ck, cv, start, window,
                           table)
    for a, b in zip(jo, po):
        np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_mla_chunk_branch_matches_jax(paged):
    """The chunk expands the whole cached latent view to K/V and runs the
    prefill math (K3's (192, 128) form at the reduced config's widths)."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    m = cfg.mla
    rs = np.random.default_rng(40 + paged)
    d, H = cfg.d_model, cfg.n_heads
    nd, rd, vd, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, \
        m.kv_lora_rank
    p = _attn_params(rs, {"w_dq": (d, H * (nd + rd)), "w_dkv": (d, r),
                          "w_krope": (d, rd), "w_uk": (r, H * nd),
                          "w_uv": (r, H * vd), "wo": (H * vd, d)})
    start, C = 16, 16
    x = _rand(rs, 1, C, d)
    if paged:
        ck, table = _paged_layout(rs, (r,), 5)
        cv = _rand(rs, ck.shape[0], ck.shape[1], rd)
    else:
        ck, cv, table = _rand(rs, 1, 48, r), _rand(rs, 1, 48, rd), None
    jo, po = _continuation("mla_fwd", jcfg, cfg, p, x, ck, cv, start, 0,
                           table)
    for a, b in zip(jo, po):
        np.testing.assert_allclose(b, a, **TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("heads,window", [((4, 1, 256, 256), 512),
                                          ((4, 1, 256, 256), 0),
                                          ((24, 8, 128, 128), 0),
                                          ((16, 16, 192, 128), 0)])
@pytest.mark.parametrize("q_off", [0, 256, 1280])
def test_cuda_chunk_matches_plain(dtype, tol, heads, window, q_off):
    """C = 256 rows at ``q_off`` over a 2048-key view valid to ``q_off +
    C``: the kernel against its plain version, one launch counted as a
    chunk launch; poison (NaN, inf, +-1e4) past ``kv_valid_len`` changes
    no bit; the rows equal the same rows of one whole-prefill call on the
    same operands bit for bit (``q_off`` is a multiple of 64)."""
    _cuda()
    Hq, Hkv, dk, dv = heads
    dt = getattr(torch, dtype)
    C, S, n = 256, 2048, q_off + 256
    g = torch.Generator(device="cuda").manual_seed(q_off + window + Hq)
    mk = lambda s, h, d: torch.randn((1, s, h, d), generator=g,
                                     device="cuda").to(dt)
    q, k, v = mk(S, Hq, dk), mk(S, Hkv, dk), mk(S, Hkv, dv)
    scale = 1.0 / math.sqrt(dk)
    qc = q[:, q_off:n].contiguous()
    kvl = torch.tensor([n], dtype=torch.int32, device="cuda")
    before = (ops.launches, ops.chunk_launches)
    out = ops.flash_attention_bshd(qc, k, v, window=window, scale=scale,
                                   q_off=q_off, kv_valid_len=kvl)
    torch.cuda.synchronize()
    assert (ops.launches, ops.chunk_launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref = flash_attention_plain(qc, k, v, window=window, scale=scale,
                                q_off=q_off, kv_valid_len=kvl)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for fill in (math.nan, math.inf, 1e4, -1e4):
        kp, vp = k.clone(), v.clone()
        kp[:, n:], vp[:, n:] = fill, fill
        assert torch.equal(out, ops.flash_attention_bshd(
            qc, kp, vp, window=window, scale=scale, q_off=q_off,
            kv_valid_len=kvl))
    whole = ops.flash_attention_bshd(q, k, v, window=window, scale=scale)
    assert torch.equal(out, whole[:, q_off:n])


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(64, 64), (80, 80), (128, 128),
                                  (256, 256), (192, 128), (48, 32)])
@pytest.mark.parametrize("q_off", [64, 192])
def test_cuda_fp32_chunk_rows_at_the_query_tile(dims, q_off):
    """fp32 (3xTF32): a chunk of 64 rows at an offset that is a multiple of
    the query tile (64), not of 128 or 256, equals the same rows of the
    whole prefill bit for bit at every fp32 build, GQA 8 over 2, with a
    window; the chunk against its plain version within 1e-4."""
    _cuda()
    dk, dv = dims
    C, S, n = 64, 640, q_off + 64
    g = torch.Generator(device="cuda").manual_seed(q_off + dk)
    mk = lambda h, d: torch.randn((1, S, h, d), generator=g, device="cuda")
    q, k, v = mk(8, dk), mk(2, dk), mk(2, dv)
    kw = dict(window=100, scale=1.0 / math.sqrt(dk))
    qc = q[:, q_off:n].contiguous()
    kvl = torch.tensor([n], dtype=torch.int32, device="cuda")
    out = ops.flash_attention_bshd(qc, k, v, q_off=q_off, kv_valid_len=kvl,
                                   **kw)
    whole = ops.flash_attention_bshd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, whole[:, q_off:n])
    ref = flash_attention_plain(qc, k, v, q_off=q_off, kv_valid_len=kvl,
                                **kw)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
