"""``pad_q_heads_to`` through the port against the JAX reference (CPU,
fp32).  JAX's padded heads are real heads: ``init_gqa`` draws
``n_heads_padded`` of them and GQA maps query head ``h`` to kv head
``h // G``, so a padded config is another model with a larger G.

For a reduced gemma3-1b (4 -> 8 query heads over 1 kv head: G 4 -> 8; a
binding window of 16 on layer 0, K4 in paged verify) and a reduced
minitron-4b (4 -> 8 over 2: G 2 -> 4), each with ``pad_q_heads_to=8``,
params JAX-initialised and carried across by ``repro_torch.bridge``:

* the padded params have JAX's shapes, and the bridge refuses an
  unpadded ``wq`` for a padded config;
* ``forward`` in full (prefill), dense-verify and paged-verify mode
  matches JAX within ``atol = rtol = 1e-4`` (hidden states, logits,
  caches), each kernel call taking the padded G;
* greedy Hydra++ ``generate()`` streams equal JAX ``generate()`` exactly
  (a 16-token vocabulary, so random heads get candidates accepted), and
  the port's paged engine (with a pool small enough to preempt) equals
  the port's dense ``generate()`` request by request.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request)
from repro_torch.training.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
BS = 16
MAX_LEN = 128
VOCAB = 16
PAD = 8
# arch: (fields replaced in reduced(), G unpadded, G padded)
ARCHS = {"gemma3-1b": (dict(window_pattern=(16, 0)), 4, 8),
         "minitron-4b": ({}, 2, 4)}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg): reduced ``arch`` in fp32, heads padded."""
    extra, _, _ = ARCHS[arch]
    return [dataclasses.replace(get(arch).reduced(), dtype="float32",
                                pad_q_heads_to=PAD, **extra, **kw)
            for get in (jax_get_config, get_config)]


def _model(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jdp = jax_init_draft(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    dp = bridge.draft_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
    return jcfg, cfg, jparams, jdp, params, dp


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    return request.param, _model(request.param)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_padding_changes_the_group_size(arch):
    _, g0, g1 = ARCHS[arch]
    jcfg, cfg = _cfgs(arch)
    unpadded = get_config(arch).reduced()
    assert unpadded.q_per_kv == g0
    assert cfg.n_heads_padded == jcfg.n_heads_padded == PAD
    assert cfg.n_heads_padded // cfg.n_kv_heads == g1


def test_params_have_jax_shapes_and_the_bridge_checks_them(model):
    _, (jcfg, cfg, jparams, jdp, params, dp) = model
    for port, jtree in ((params, jparams), (dp, jdp)):
        got = [tuple(t.shape) for t in tree_leaves(port)]
        want = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]
        assert got == want
    hd = cfg.resolved_head_dim
    assert tuple(params["groups"][0]["attn"]["wq"].shape[-1:]) == (PAD * hd,)
    unpadded = dataclasses.replace(cfg, pad_q_heads_to=0)
    with pytest.raises(ValueError, match="wq"):
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               unpadded, "cpu")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _assert_outputs_match(out, jout):
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for g, jg in zip(out.cache, jout.cache):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(g[key]), np.asarray(jg[key]),
                                       **TOL)


def _prefill(model, B, P, seed):
    _, (jcfg, cfg, jparams, _, params, _) = model
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="full",
                             cache=jax_model.init_cache(jcfg, B, 64))
    out = forward(params, cfg, _t(toks), _t(pos), mode="full",
                  cache=init_cache(cfg, B, 64, "cpu"))
    return jout, out


def _verify_inputs(cfg, lens, seed):
    rs = np.random.default_rng(seed)
    tree = default_tree(8, 2, 3)
    T = tree.depth.shape[0]
    toks = rs.integers(0, cfg.vocab_size, (len(lens), T)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + tree.depth[None, :]).astype(np.int32)
    return tree.ancestor_mask, toks, pos, np.asarray(lens, np.int32)


def test_forward_full_matches_jax(model):
    """A 40-token prefill (gemma3's window of 16 binds on layer 0)."""
    _assert_outputs_match(*_prefill(model, 2, 40, seed=3)[::-1])


def test_forward_dense_verify_matches_jax(model):
    _, (jcfg, cfg, jparams, _, params, _) = model
    jout0, out0 = _prefill(model, 2, 40, seed=4)
    tm, toks, pos, lens = _verify_inputs(cfg, [40, 29], seed=5)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="verify",
                             cache=jout0.cache, cache_len=jnp.asarray(lens),
                             tree_mask=jnp.asarray(tm))
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify",
                  cache=out0.cache, cache_len=_t(lens), tree_mask=_t(tm))
    _assert_outputs_match(out, jout)


def _paged_case(cfg, seed):
    """Pools per group with a poisoned NULL block, ragged lens past the
    window and a NULL hole below cache_len."""
    rs = np.random.default_rng(seed)
    N, hd = 12, cfg.resolved_head_dim
    shape = lambda n: (n, N, BS, cfg.n_kv_heads, hd)
    pools = [{k: rs.standard_normal(shape(n), dtype=np.float32)
              for k in ("k", "v")}
             for _, n in port_model.group_program(cfg)]
    for g in pools:
        for p in g.values():
            p[:, 0] = 1e4                       # NULL garbage
    table = np.array([[1, 2, 3, 0, 0], [0, 4, 5, 6, 7]], np.int32)
    return pools, table


def test_forward_paged_verify_matches_jax(model):
    """JAX's paged Pallas kernels in interpret mode against the port's
    plain K1/K4 at the padded G."""
    _, (jcfg, cfg, jparams, _, params, _) = model
    pools, table = _paged_case(cfg, seed=6)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], seed=7)
    jout = jax_model.forward(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), mode="verify",
        cache=[{k: jnp.asarray(v) for k, v in g.items()} for g in pools],
        cache_len=jnp.asarray(lens), tree_mask=jnp.asarray(tm),
        block_table=jnp.asarray(table))
    cache = [{k: _t(v.copy()) for k, v in g.items()} for g in pools]
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
                  cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    _assert_outputs_match(out, jout)


def test_kernels_take_the_padded_group(monkeypatch, model):
    """Every K3, K1, K4 and K2 call has ``n_heads_padded`` query heads
    over ``n_kv_heads``."""
    arch, (_, cfg, _, _, params, _) = model
    calls = []
    for name in ("flash_attention_bshd", "tree_attention_paged_bshd",
                 "tree_attention_paged_windowed_bshd", "tree_attention_bshd"):
        fn = getattr(attn_mod, name)
        monkeypatch.setattr(
            attn_mod, name, lambda *a, _n=name, _f=fn, **kw: calls.append(
                (_n, a[0].shape[2], a[1].shape[-2])) or _f(*a, **kw))
    G = (PAD, cfg.n_kv_heads)
    toks = torch.randint(0, cfg.vocab_size, (1, 24))
    forward(params, cfg, toks, torch.arange(24)[None], mode="full")
    pools, table = _paged_case(cfg, seed=8)
    tm, vt, pos, lens = _verify_inputs(cfg, [37, 55], seed=9)
    cache = [{k: _t(v) for k, v in g.items()} for g in pools]
    forward(params, cfg, _t(vt), _t(pos), mode="verify", cache=cache,
            cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    forward(params, cfg, _t(vt), _t(pos), mode="verify",
            cache=init_cache(cfg, 2, 64, "cpu"), cache_len=_t(lens),
            tree_mask=_t(tm))
    names = [n for n, _, _ in calls]
    paged = ("tree_attention_paged_windowed_bshd" if arch == "gemma3-1b"
             else "tree_attention_paged_bshd")
    assert names.count("flash_attention_bshd") == cfg.n_layers
    assert names.count(paged) == cfg.n_layers
    assert "tree_attention_bshd" in names
    assert all((hq, hkv) == G for _, hq, hkv in calls)


# ---------------------------------------------------------------------------
# generate and the paged engine
# ---------------------------------------------------------------------------


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN]
            for row in np.asarray(toks)]


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    return _model(request.param, vocab_size=VOCAB)


def test_generate_matches_jax(served):
    jcfg, cfg, jparams, jdp, params, dp = served
    tree = tree_for(cfg)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 24)).astype(
        np.int32)
    jt, jsteps, jacc = jax_generate(jparams, jdp, jcfg, tree,
                                    jnp.asarray(prompt), max_new_tokens=20,
                                    max_len=MAX_LEN)
    t, steps, acc = generate(params, dp, cfg, tree,
                             torch.from_numpy(prompt).long(),
                             max_new_tokens=20, max_len=MAX_LEN)
    assert steps == jsteps
    assert _stream(_np(t)) == _stream(jt)
    np.testing.assert_array_equal(_np(acc), np.asarray(jacc))
    assert float(acc.max()) > 1.0, "no candidate was ever accepted"


def test_paged_engine_matches_dense_generate(served):
    """Ragged prompts (past gemma3's window) through a pool small enough
    to preempt: each request equals the port's dense ``generate()``."""
    _, cfg, _, _, params, dp = served
    tree = tree_for(cfg)
    rs = np.random.default_rng(4)
    reqs, refs = [], []
    for n, budget in zip((17, 23, 30, 19), (12, 14, 8, 10)):
        prompt = rs.integers(0, VOCAB, n).astype(np.int32)
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(prompt)[None].long(),
                           max_new_tokens=budget, max_len=MAX_LEN)
        refs.append(_stream(_np(t))[0][:budget])
        reqs.append(Request(prompt=prompt, max_new_tokens=budget))
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=6, inflight=1,
                                 device="cpu")
    stats = eng.serve(reqs, max_batch=4)
    for r, ref in zip(reqs, refs):
        assert r.done and r.output == ref
    assert stats.preemptions >= 1
    assert eng._alloc.blocks_in_use == 0
