"""The port's multi-head latent attention (MLA) and its paged kernel K5
against the JAX reference.

* ``mla_fwd``'s three ported branches (full-sequence prefill, dense
  absorbed verify, paged absorbed verify) against JAX ``mla_fwd`` on a
  reduced deepseek-v2-lite-16b layer (fp32, params initialised in JAX),
  ``atol = rtol = 1e-4``; the JAX paged branch runs its Pallas kernel in
  interpret mode, the port K5's plain version;
* K5's plain version against the JAX kernel (interpret mode) and the JAX
  oracle ``mla_attention_paged_ref``, at block 16 and 128, with NULL
  holes, ``atol = rtol = 2e-5`` (fp32, the sums run in different
  orders); poison in the NULL block (0, +-1e4, NaN, inf) changes no
  output bit; the wrapper pads T on the CPU path (the split sweep's
  plain version: ``test_torch_mla_split.py``);
* the window hook: the wrapper's plain path against JAX's wrapper
  (interpret mode) and oracle at windows 0, -1, 1, 5, 64 and past every
  length, ``q_pos = cache_len + depth``, NULL holes and a poisoned NULL
  block, ``atol = rtol = 2e-5``; a window <= 0 bitwise the unwindowed
  call; a window without ``q_pos`` raises ``ValueError``;
* the MLA prefill: q/k (nd + rd) and v (vd) through K3's plain version
  at their own widths (K3's bf16 build takes deepseek's 192/128 unpadded;
  the test keeps its first name) with the scale 1/sqrt(nd + rd), against
  JAX ``blocked_attention``, at the reduced and at deepseek's own
  widths, ``atol = rtol = 1e-5``.

The CUDA kernel against its plain version is ``gpu``-marked; it skips
without a card.  The JAX side is imported inside the helpers that run it,
so the ``gpu`` cases also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_mla.py
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k3  # noqa: E402
from repro_torch.kernels.mla_attention import ops  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_attention_paged_plain)
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg():
    return dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                               dtype="float32")


# ---------------------------------------------------------------------------
# K5: the plain version against the JAX kernel and oracle
# ---------------------------------------------------------------------------


def _cover_tables(lens, T, bs, M, num_blocks, holes=()):
    """Ascending-id tables covering [0, len + T) per row; ``holes``:
    (row, logical block) entries punched back to NULL."""
    table = np.zeros((len(lens), M), np.int32)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(int(n) + T) // bs)
        assert need <= M and nxt + need <= num_blocks
        table[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    for b, j in holes:
        table[b, j] = 0
    return table


def _k5_case(seed, bs, B=3, T=8, H=4, r=64, rd=16, holes=()):
    """fp32 operands from a numpy seed: ragged lens (a partial last block,
    an empty row), the scale of nd = r // 2."""
    rs = np.random.default_rng(seed)
    M = -(-(2 * bs + 40) // bs) + 1
    N = B * M + 1
    lens = [bs + 5, 0, 2 * bs + 3][:B]
    f = lambda *s: rs.standard_normal(s, dtype=np.float32)
    return dict(q_lat=f(B, T, H, r), q_rope=f(B, T, H, rd),
                pool_lat=f(N, bs, r), pool_rope=f(N, bs, rd),
                tree_lat=f(B, T, r), tree_rope=f(B, T, rd),
                tree_mask=default_tree(T, 2, 3).ancestor_mask,
                cache_len=np.asarray(lens, np.int32),
                block_table=_cover_tables(lens, T, bs, M, N, holes),
                scale=1.0 / math.sqrt(r // 2 + rd))


def _port_k5(c):
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    scale = t.pop("scale")
    return ops.mla_attention_paged_bshd(*t.values(), scale=scale).numpy()


def _jax_k5(name, c):
    import jax.numpy as jnp
    from repro.kernels.attention_template.ops import mla_attention_paged_bshd
    from repro.kernels.attention_template.ref import mla_attention_paged_ref

    fn, kw = ((mla_attention_paged_bshd, {"interpret": True})
              if name == "kernel" else (mla_attention_paged_ref, {}))
    args = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}
    scale = args.pop("scale")
    return np.asarray(fn(*args.values(), scale=scale, **kw))


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("holes", [(), ((2, 1),)], ids=["full", "holes"])
def test_plain_matches_jax_kernel_and_ref(bs, holes):
    c = _k5_case(bs, bs, holes=holes)
    out = _port_k5(c)
    np.testing.assert_allclose(out, _jax_k5("kernel", c), **TOL)
    np.testing.assert_allclose(out, _jax_k5("ref", c), **TOL)


def test_null_holes_are_masked():
    """A hole below cache_len changes the result: it is skipped, not
    read."""
    c = _k5_case(3, 16, holes=((2, 1),))
    full = _port_k5(dict(c, block_table=_k5_case(3, 16)["block_table"]))
    assert np.max(np.abs(_port_k5(c) - full)) > 1e-3


@pytest.mark.parametrize("fill", [1e4, -1e4, np.nan, np.inf, -np.inf])
def test_poisoned_null_block_never_reaches_output(fill):
    """Whatever physical block 0 holds, through the unallocated tail or a
    hole below cache_len, not one output bit changes."""
    c = _k5_case(4, 16, holes=((0, 0),))
    outs = []
    for f in (0.0, fill):
        cc = dict(c, pool_lat=c["pool_lat"].copy(),
                  pool_rope=c["pool_rope"].copy())
        cc["pool_lat"][0] = f
        cc["pool_rope"][0] = f
        outs.append(_port_k5(cc))
    assert np.isfinite(outs[1]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_wrapper_pads_T_and_refuses_the_window():
    """T = 13 is padded to 16 around the plain version and sliced back."""
    c = _k5_case(5, 16, T=13)
    c["tree_mask"] = default_tree(13, 4, 4).ancestor_mask
    out = _port_k5(c)
    assert out.shape == (3, 13, 4, 64)
    np.testing.assert_allclose(out, _jax_k5("ref", c), **TOL)


# ---------------------------------------------------------------------------
# K5's window hook: the plain version against JAX's wrapper and oracle
# ---------------------------------------------------------------------------

# windows: off (0, -1), one position, a few, a block's worth, and past
# every length of the case (lens up to 2 * 16 + 3 plus a tree of 13)
WINDOWS = (0, -1, 1, 5, 64, 1000)


def _windowed_case(seed, T=13):
    """``_k5_case`` with T = 13 (padded to 16 on the CPU path), a NULL hole
    below cache_len and the verify positions q_pos = cache_len + depth of
    ``default_tree(13, 4, 4)``."""
    c = _k5_case(seed, 16, T=T, holes=((2, 1),))
    tree = default_tree(T, 4, 4)
    c["tree_mask"] = tree.ancestor_mask
    q_pos = (c["cache_len"][:, None] + tree.depth[None, :]).astype(np.int32)
    return c, q_pos


def _poisoned(c):
    """``c`` with NaN and inf in the NULL block (which JAX's oracle, a
    gather and a product, would carry into its output)."""
    c = dict(c, pool_lat=c["pool_lat"].copy(),
             pool_rope=c["pool_rope"].copy())
    c["pool_lat"][0] = np.nan
    c["pool_rope"][0] = np.inf
    return c


def _port_k5_windowed(c, q_pos, window):
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    scale = t.pop("scale")
    return ops.mla_attention_paged_bshd(
        *t.values(), scale=scale, q_pos=torch.from_numpy(q_pos),
        window=window).numpy()


def _jax_k5_windowed(name, c, q_pos, window):
    import jax.numpy as jnp
    from repro.kernels.attention_template.ops import mla_attention_paged_bshd
    from repro.kernels.attention_template.ref import mla_attention_paged_ref

    args = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}
    scale = args.pop("scale")
    if name == "kernel":
        return np.asarray(mla_attention_paged_bshd(
            *args.values(), scale=scale, q_pos=jnp.asarray(q_pos),
            window=window, interpret=True))
    return np.asarray(mla_attention_paged_ref(
        *args.values(), scale=scale, q_pos=jnp.asarray(q_pos),
        window=window))


@pytest.mark.parametrize("window", WINDOWS)
def test_window_matches_jax_kernel_and_ref(window):
    """The port's wrapper (plain path) with ``q_pos = cache_len + depth``
    against JAX's wrapper in interpret mode and its oracle at each window,
    with a NULL hole, ``atol = rtol = 2e-5`` (fp32, the sums in different
    orders); NaN and inf in the NULL block change no output bit (JAX's
    oracle is given the clean pool)."""
    c, q_pos = _windowed_case(10)
    out = _port_k5_windowed(_poisoned(c), q_pos, window)
    assert out.shape == (3, 13, 4, 64) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, _port_k5_windowed(c, q_pos, window))
    np.testing.assert_allclose(
        out, _jax_k5_windowed("kernel", _poisoned(c), q_pos, window), **TOL)
    np.testing.assert_allclose(
        out, _jax_k5_windowed("ref", c, q_pos, window), **TOL)


@pytest.mark.parametrize("window", [0, -1, -64])
def test_window_off_is_the_unwindowed_call(window):
    """A window <= 0 is an exact no-op: bit for bit the unwindowed call."""
    c, q_pos = _windowed_case(11)
    np.testing.assert_array_equal(_port_k5_windowed(c, q_pos, window),
                                  _port_k5(c))


@pytest.mark.parametrize("window", [1, 5])
def test_window_changes_the_result(window):
    """A short window drops keys (the window is applied, not ignored)."""
    c, q_pos = _windowed_case(12)
    assert np.max(np.abs(_port_k5_windowed(c, q_pos, window)
                         - _port_k5(c))) > 1e-3


def test_window_without_q_pos_raises():
    """As JAX's wrapper: a window needs q_pos."""
    c, _ = _windowed_case(13)
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    scale = t.pop("scale")
    with pytest.raises(ValueError, match="q_pos"):
        ops.mla_attention_paged_bshd(*t.values(), scale=scale, window=64)


def test_cpu_path_launches_no_kernel():
    before = ops.launches
    _port_k5(_k5_case(6, 16))
    assert ops.launches == before


# ---------------------------------------------------------------------------
# the MLA prefill: padded K3 with an explicit scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nd,rd,vd,H,S", [(32, 16, 32, 4, 40),
                                          (128, 64, 128, 2, 96)],
                         ids=["reduced", "deepseek"])
def test_padded_prefill_matches_blocked_attention(nd, rd, vd, H, S):
    import jax.numpy as jnp
    from repro.models.layers import blocked_attention

    rs = np.random.default_rng(nd)
    q, k = (rs.standard_normal((1, S, H, nd + rd), dtype=np.float32)
            for _ in range(2))
    v = rs.standard_normal((1, S, H, vd), dtype=np.float32)
    scale = 1.0 / math.sqrt(nd + rd)
    pos = np.arange(S)
    ref = blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos)[None], jnp.asarray(pos),
                            causal=True, scale=scale)
    ai = attention.AttnInputs(q_pos=torch.from_numpy(pos)[None],
                              cache_k=None, cache_v=None, cache_len=None,
                              tree_mask=None, window=0, causal=True)
    before = k3.launches
    out = attention._mla_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), ai,
        scale)
    assert k3.launches == before
    assert out.shape == (1, S, H, vd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# mla_fwd: the three branches against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models.attention import init_mla
    from repro_torch import bridge

    jcfg = dataclasses.replace(
        jax_get_config("deepseek-v2-lite-16b").reduced(), dtype="float32")
    jp = init_mla(jax.random.PRNGKey(0), jcfg, np.float32)
    p = bridge._convert(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, _cfg(), jp, p


def _both(layer, x, q_pos, **ai_kw):
    """JAX and port mla_fwd on the same inputs; numpy outputs."""
    import jax.numpy as jnp
    from repro.models import attention as jattn

    jcfg, cfg, jp, p = layer
    jai = jattn.AttnInputs(
        q_pos=jnp.asarray(q_pos),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in ai_kw.items()})
    tai = attention.AttnInputs(
        q_pos=torch.from_numpy(q_pos),
        **{k: (torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
               else v) for k, v in ai_kw.items()})
    jout = jattn.mla_fwd(jp, jcfg, jnp.asarray(x), jai)
    out = attention.mla_fwd(p, cfg, torch.from_numpy(x), tai)
    return ([np.asarray(a) for a in jout],
            [a.detach().numpy() for a in out])


def _x(cfg, B, T, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model), dtype=np.float32)


def test_mla_fwd_full_matches_jax(layer):
    cfg = layer[1]
    B, T = 2, 40
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    jout, out = _both(layer, _x(cfg, B, T, 1), pos, cache_k=None,
                      cache_v=None, cache_len=None, tree_mask=None,
                      window=0, causal=True)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


def _verify_case(cfg, lens, T, seed):
    tree = default_tree(T, 2, 3)
    pos = (np.asarray(lens)[:, None] + tree.depth[None, :]).astype(np.int32)
    return (_x(cfg, len(lens), T, seed), pos, tree.ancestor_mask,
            np.asarray(lens, np.int32))


def test_mla_fwd_dense_verify_matches_jax(layer):
    cfg = layer[1]
    m = cfg.mla
    S = 64
    x, pos, tm, lens = _verify_case(cfg, [40, 29], 8, seed=2)
    rs = np.random.default_rng(3)
    ck = rs.standard_normal((2, S, m.kv_lora_rank), dtype=np.float32)
    cv = rs.standard_normal((2, S, m.qk_rope_dim), dtype=np.float32)
    jout, out = _both(layer, x, pos, cache_k=ck, cache_v=cv, cache_len=lens,
                      tree_mask=tm, window=0, causal=True)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


@pytest.mark.parametrize("tree", [True, False], ids=["tree", "chain"])
def test_mla_fwd_paged_verify_matches_jax(layer, tree):
    """Pools with a poisoned NULL block and a hole below cache_len; JAX's
    Pallas MLA kernel in interpret mode against the port's plain K5."""
    cfg = layer[1]
    m = cfg.mla
    bs, N = 16, 12
    x, pos, tm, lens = _verify_case(cfg, [37, 20], 8, seed=4)
    rs = np.random.default_rng(5)
    pk = rs.standard_normal((N, bs, m.kv_lora_rank), dtype=np.float32)
    pv = rs.standard_normal((N, bs, m.qk_rope_dim), dtype=np.float32)
    pk[0] = pv[0] = 1e4                           # NULL garbage
    table = np.array([[1, 2, 3, 0, 0], [0, 4, 5, 0, 0]], np.int32)
    jout, out = _both(layer, x, pos, cache_k=pk, cache_v=pv,
                      cache_len=lens, tree_mask=tm if tree else None,
                      window=0, causal=True, block_table=table)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, b, **MODEL_TOL)


# ---------------------------------------------------------------------------
# the CUDA kernel (card only)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,H,r,rd", [(16, 16, 512, 64), (5, 4, 64, 16)],
                         ids=["deepseek", "reduced"])
@pytest.mark.parametrize("split_len", [None, 16, 4096],
                         ids=["planner", "split16", "one-split"])
def test_cuda_kernel_matches_plain(dtype, tol, T, H, r, rd, split_len):
    """K5 against its plain version on the card at the planner's split
    and forced ones: ragged lens, holes, a poisoned NULL block (bitwise
    equal outputs for every fill), two identical calls bitwise equal, and
    the split's plain version at the same split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.mla_attention.ref import (
        mla_attention_paged_split)
    from repro_torch.kernels.tree_attention.split import plan_mla_split_len

    torch.backends.cuda.matmul.allow_tf32 = False
    c = _k5_case(7, 16, B=3, T=T, H=H, r=r, rd=rd, holes=((2, 1),))
    if T != 8:
        c["tree_mask"] = default_tree(T, 4, 4).ancestor_mask
    dt = getattr(torch, dtype)
    outs = []
    for fill in (0.0, np.nan, np.inf, -1e4):
        t = {k: (torch.from_numpy(v).cuda() if isinstance(v, np.ndarray)
                 else v) for k, v in c.items()}
        for k in ("pool_lat", "pool_rope", "tree_lat", "tree_rope"):
            t[k] = t[k].to(dt)
        t["pool_lat"][0] = fill
        t["pool_rope"][0] = fill
        scale = t.pop("scale")
        before = (ops.launches, ops.merge_launches)
        outs.append(ops.mla_attention_paged_bshd(*t.values(), scale=scale,
                                                 split_len=split_len))
        torch.cuda.synchronize()
        assert (ops.launches, ops.merge_launches) == (before[0] + 1,
                                                      before[1] + 1)
    outs.append(ops.mla_attention_paged_bshd(*t.values(), scale=scale,
                                             split_len=split_len))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    ref = mla_attention_paged_plain(*t.values(), scale=scale)
    torch.testing.assert_close(outs[-1], ref, atol=tol, rtol=tol)
    n = split_len or plan_mla_split_len(3, H, T, r, rd)
    ref = mla_attention_paged_split(*t.values(), scale=scale, split_len=n)
    torch.testing.assert_close(outs[-1], ref, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,H,r,rd", [(16, 16, 512, 64), (5, 4, 64, 16)],
                         ids=["deepseek", "reduced"])
def test_cuda_windowed_kernel_matches_plain(dtype, tol, T, H, r, rd):
    """K5's windowed form against its plain version on the card at windows
    1, 5 and 512, the planner's split and 16 (a split wholly behind the
    window at 1 and 5), with a poisoned NULL block; window 0 bitwise the
    unwindowed call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = _k5_case(8, 16, B=3, T=T, H=H, r=r, rd=rd, holes=((2, 1),))
    tree = default_tree(T, 4, 4)
    c["tree_mask"] = tree.ancestor_mask
    c["pool_lat"][0] = np.nan
    c["pool_rope"][0] = np.inf
    q_pos = torch.from_numpy((c["cache_len"][:, None] + tree.depth[None, :])
                             .astype(np.int32)).cuda()
    t = {k: (torch.from_numpy(v).cuda() if isinstance(v, np.ndarray)
             else v) for k, v in c.items()}
    for k in ("pool_lat", "pool_rope", "tree_lat", "tree_rope"):
        t[k] = t[k].to(getattr(torch, dtype))
    scale = t.pop("scale")
    args = list(t.values())
    off = ops.mla_attention_paged_bshd(*args, scale=scale, q_pos=q_pos,
                                       window=0)
    assert torch.equal(off, ops.mla_attention_paged_bshd(*args,
                                                         scale=scale))
    for window in (1, 5, 512):
        ref = mla_attention_paged_plain(*args, scale=scale, q_pos=q_pos,
                                        window=window)
        for split_len in (None, 16):
            out = ops.mla_attention_paged_bshd(
                *args, scale=scale, q_pos=q_pos, window=window,
                split_len=split_len)
            again = ops.mla_attention_paged_bshd(
                *args, scale=scale, q_pos=q_pos, window=window,
                split_len=split_len)
            assert torch.equal(out, again)
            torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
