"""The port's layers and model forward against the JAX reference.

Same numpy inputs and the same params (JAX init, converted through
``repro_torch.bridge``) go through both packages in fp32: the layer
primitives, then ``forward`` in full mode (prefill with a cache), dense
verify mode and paged verify mode.  The paged JAX forward runs its Pallas
kernel in interpret mode (the CPU default); the port runs the kernel's
plain version.  Logits, hidden states and caches agree within
``atol = rtol = 1e-4``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.trees import default_tree  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import forward, init_cache, init_params  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
BS = 16


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def model():
    name = "minitron-4b"
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norm_rope_mlp_match_jax():
    rs = np.random.default_rng(0)
    x = rs.standard_normal((2, 5, 4, 64), dtype=np.float32)
    g = rs.standard_normal((64,), dtype=np.float32) * 0.1
    np.testing.assert_allclose(_np(tl.rms_norm(_t(x), _t(g))),
                               np.asarray(jl.rms_norm(x, g)), **TOL)
    pos = rs.integers(0, 500, (2, 5)).astype(np.int32)
    sin, cos = tl.rope_sincos(_t(pos), 64, 10000.0)
    jsin, jcos = jl.rope_sincos(jnp.asarray(pos), 64, 10000.0)
    np.testing.assert_allclose(_np(sin), np.asarray(jsin), **TOL)
    np.testing.assert_allclose(_np(cos), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(_np(tl.apply_rope(_t(x), sin, cos)),
                               np.asarray(jl.apply_rope(x, jsin, jcos)),
                               **TOL)
    p = {k: rs.standard_normal(s, dtype=np.float32) * 0.1
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    np.testing.assert_allclose(
        _np(tl.mlp_fwd({k: _t(v) for k, v in p.items()}, _t(x))),
        np.asarray(jl.mlp_fwd(p, x)), **TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_blocked_attention_matches_jax(window):
    """Q-block and KV-block paths, kv_valid_len and a traced window."""
    rs = np.random.default_rng(1)
    B, Tq, Hq, Hkv, D, S = 2, 16, 4, 2, 32, 24
    q = rs.standard_normal((B, Tq, Hq, D), dtype=np.float32)
    k = rs.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rs.standard_normal((B, S, Hkv, D), dtype=np.float32)
    q_pos = np.broadcast_to(np.arange(4, 4 + Tq), (B, Tq)).astype(np.int32)
    kv_pos = np.arange(S, dtype=np.int32)
    vlen = np.array([17, 9], np.int32)
    kw = dict(causal=True, kv_block=8, q_block=8)
    out = tl.blocked_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                               window=torch.tensor(window), kv_valid_len=_t(vlen),
                               **kw)
    ref = jl.blocked_attention(q, k, v, q_pos, kv_pos,
                               window=jnp.asarray(window), kv_valid_len=vlen,
                               **kw)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def test_masked_attention_matches_jax():
    rs = np.random.default_rng(2)
    B, T, Hq, Hkv, D, S = 2, 6, 4, 2, 32, 12
    q = rs.standard_normal((B, T, Hq, D), dtype=np.float32)
    k = rs.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rs.standard_normal((B, S, Hkv, D), dtype=np.float32)
    mask = rs.random((B, T, S)) < 0.5
    mask[0, 0] = False                         # a fully masked row -> 0
    out = tl.masked_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(_np(out), np.asarray(
        jl.masked_attention(q, k, v, mask)), **TOL)


def test_init_distributions():
    """Same distributions as the JAX init (not the same numbers)."""
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512, torch.float32, "cpu")
    e = tl.embed_init(gen, 512, 256, torch.float32, "cpu")
    assert abs(w.std().item() - 1 / 16) < 2e-3 and abs(w.mean()) < 2e-3
    assert abs(e.std().item() - 0.02) < 1e-3


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def test_bridge_round_trip(model):
    jcfg, cfg, jparams, params = model
    back = bridge.to_numpy(params)
    flat_j, tdef = jax.tree_util.tree_flatten(jparams)
    flat_t, tdef_t = jax.tree_util.tree_flatten(back)
    assert tdef == tdef_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(_np(params["unembed_f32"]),
                                  np.asarray(jparams["lm_head"]))


def _prefill(model, B, P, seed):
    """Prefill the same prompts on both sides; returns both caches."""
    jcfg, cfg, jparams, params = model
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    from repro.models.model import init_cache as jax_init_cache
    jout = jax_forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                       mode="full", cache=jax_init_cache(jcfg, B, 64))
    cache = init_cache(cfg, B, 64, "cpu")
    out = forward(params, cfg, _t(toks), _t(pos), mode="full", cache=cache)
    return jout, out


def test_forward_full_matches_jax(model):
    jout, out = _prefill(model, 2, 20, seed=3)
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def _verify_inputs(cfg, B, T, lens, seed):
    rs = np.random.default_rng(seed)
    tree = default_tree(T, 2, 3)
    toks = rs.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + tree.depth[None, :]).astype(np.int32)
    return tree, toks, pos, np.asarray(lens, np.int32)


def test_forward_dense_verify_matches_jax(model):
    jcfg, cfg, jparams, params = model
    jout0, out0 = _prefill(model, 2, 20, seed=4)
    tree, toks, pos, lens = _verify_inputs(cfg, 2, 8, [20, 13], seed=5)
    tm = tree.ancestor_mask
    jout = jax_forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                       mode="verify", cache=jout0.cache,
                       cache_len=jnp.asarray(lens), tree_mask=jnp.asarray(tm))
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify",
                  cache=out0.cache, cache_len=_t(lens), tree_mask=_t(tm))
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def test_forward_paged_verify_matches_jax(model):
    """Pools with ragged lens and a NULL-poisoned block 0: the JAX Pallas
    kernel (interpret mode) against the port's plain version."""
    jcfg, cfg, jparams, params = model
    B, T, N, M = 2, 8, 12, 4
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    rs = np.random.default_rng(6)
    pools = {k: rs.standard_normal((L, N, BS, Hkv, D), dtype=np.float32)
             for k in ("k", "v")}
    for p in pools.values():
        p[:, 0] = 1e4                           # NULL garbage
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    tree, toks, pos, lens = _verify_inputs(cfg, B, T, [37, 9], seed=7)
    tm = tree.ancestor_mask
    jout = jax_forward(jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                       mode="verify",
                       cache=[{k: jnp.asarray(v) for k, v in pools.items()}],
                       cache_len=jnp.asarray(lens), tree_mask=jnp.asarray(tm),
                       block_table=jnp.asarray(table))
    cache = [{k: _t(v.copy()) for k, v in pools.items()}]
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
                  cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def test_port_init_runs_forward():
    """The port's own seeded init serves a full-mode forward on the CPU."""
    cfg = dataclasses.replace(get_config("vicuna-tiny"), dtype="float32",
                              n_layers=1)
    params = init_params(cfg, seed=3, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 7))
    out = forward(params, cfg, toks, torch.arange(7)[None], mode="full")
    assert out.logits.shape == (1, 7, cfg.vocab_size)
    assert torch.isfinite(out.logits).all()
