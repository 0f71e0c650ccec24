"""gemma3-1b through the port against the JAX reference: the
sliding-window family (5 local : 1 global layers), one kv head, tied
embeddings.

A reduced gemma3-1b (2 layers, d 256, 4 query heads over 1 kv head, fp32)
whose window binds (``window_pattern=(16, 0)``: layer 0 sees 16 tokens,
layer 1 all), with params initialised in JAX and converted through
``repro_torch.bridge``:

* the window helpers (``_window_array``, ``group_has_window``) agree
  with JAX on the full config;
* ``forward`` in full mode (prefill), dense verify and paged verify mode
  matches JAX ``forward`` within ``atol = rtol = 1e-4``, at head dim 64
  and at gemma3's own 256; the JAX paged path runs its windowed Pallas
  kernel in interpret mode, the port the plain K4;
* the paged verify of a windowed group goes through K4 on every layer,
  the prefix layer through K1, the prefill through K3;
* ``generate()`` greedy streams equal JAX ``generate()`` exactly, and the
  port's paged engine equals JAX serial ``generate()`` request by request
  on ragged prompts, with a pool small enough to force preemption.
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
from repro_torch.core.heads import prefix_forward  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
BS = 16
WINDOW = 16
MAX_LEN = 128


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfgs(**kw):
    """(JAX cfg, port cfg): reduced gemma3-1b in fp32 with a binding
    window, plus ``kw``."""
    return [dataclasses.replace(get("gemma3-1b").reduced(), dtype="float32",
                                window_pattern=(WINDOW, 0), **kw)
            for get in (jax_get_config, get_config)]


@pytest.fixture(scope="module", params=[64, 256], ids=["hd64", "hd256"])
def model(request):
    jcfg, cfg = _cfgs(head_dim=request.param)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def test_reduced_config_is_gemma3_shaped():
    jcfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.tie_embeddings) == (4, 1, True)
    full = get_config("gemma3-1b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config("gemma3-1b"))
    assert (full.head_dim, full.n_layers, full.window_pattern) == (
        256, 26, (512, 512, 512, 512, 512, 0))


def test_window_helpers_match_jax():
    cfg = get_config("gemma3-1b")
    jcfg = jax_get_config("gemma3-1b")
    assert port_model.group_program(cfg) == jax_model.group_program(jcfg)
    for off, n in ((0, 26), (5, 1), (11, 1), (0, 5), (17, 6)):
        assert port_model._window_array(cfg, n, off) == list(
            np.asarray(jax_model._window_array(jcfg, n, off)))
        assert port_model.group_has_window(cfg, off, n) == \
            jax_model.group_has_window(jcfg, off, n)
    assert not port_model.group_has_window(get_config("minitron-4b"), 0, 32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _prefill(model, B, P, seed):
    """Prefill the same prompts on both sides; returns both outputs."""
    jcfg, cfg, jparams, params = model
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="full",
                             cache=jax_model.init_cache(jcfg, B, 64))
    out = forward(params, cfg, _t(toks), _t(pos), mode="full",
                  cache=init_cache(cfg, B, 64, "cpu"))
    return jout, out


def _assert_outputs_match(out, jout):
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def test_forward_full_matches_jax(model):
    """A 40-token prefill: layer 0's window of 16 binds."""
    _assert_outputs_match(*_prefill(model, 2, 40, seed=3)[::-1])


def _verify_inputs(cfg, lens, T, seed):
    rs = np.random.default_rng(seed)
    tree = default_tree(T, 2, 3)
    toks = rs.integers(0, cfg.vocab_size, (len(lens), T)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + tree.depth[None, :]).astype(np.int32)
    return tree.ancestor_mask, toks, pos, np.asarray(lens, np.int32)


def test_forward_dense_verify_matches_jax(model):
    jcfg, cfg, jparams, params = model
    jout0, out0 = _prefill(model, 2, 40, seed=4)
    tm, toks, pos, lens = _verify_inputs(cfg, [40, 29], 8, seed=5)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="verify",
                             cache=jout0.cache, cache_len=jnp.asarray(lens),
                             tree_mask=jnp.asarray(tm))
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify",
                  cache=out0.cache, cache_len=_t(lens), tree_mask=_t(tm))
    _assert_outputs_match(out, jout)


def _paged_case(cfg, seed):
    """Pools with ragged lens past the window, a NULL hole behind the
    window and one in its reach, and a poisoned NULL block."""
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    rs = np.random.default_rng(seed)
    N = 12
    pools = {k: rs.standard_normal((L, N, BS, Hkv, D), dtype=np.float32)
             for k in ("k", "v")}
    for p in pools.values():
        p[:, 0] = 1e4                           # NULL garbage
    table = np.array([[1, 2, 3, 0, 0], [0, 4, 5, 6, 7]], np.int32)
    return pools, table


def test_forward_paged_verify_matches_jax(model):
    """The JAX windowed Pallas kernel (interpret mode) against the port's
    plain K4 on the base layers."""
    jcfg, cfg, jparams, params = model
    pools, table = _paged_case(cfg, seed=6)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], 8, seed=7)
    table[1, 3] = 0                              # a hole in the window
    jout = jax_model.forward(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), mode="verify",
        cache=[{k: jnp.asarray(v) for k, v in pools.items()}],
        cache_len=jnp.asarray(lens), tree_mask=jnp.asarray(tm),
        block_table=jnp.asarray(table))
    cache = [{k: _t(v.copy()) for k, v in pools.items()}]
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
                  cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    _assert_outputs_match(out, jout)


def _count_calls(monkeypatch, module, name, record):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        record.append((name, a[-1] if name.endswith("windowed_bshd")
                       else kw.get("window")))
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def test_kernels_each_path_takes(monkeypatch, model):
    """Prefill: K3 on every layer with its own window.  Paged verify of
    the windowed group: K4 on every layer (window 16, then 0 for the
    global layer), none through K1; the Hydra++ prefix layer: K1."""
    jcfg, cfg, jparams, params = model
    calls = []
    for name in ("flash_attention_bshd", "tree_attention_paged_bshd",
                 "tree_attention_paged_windowed_bshd"):
        _count_calls(monkeypatch, attn_mod, name, calls)
    toks = torch.randint(0, cfg.vocab_size, (1, 24))
    forward(params, cfg, toks, torch.arange(24)[None], mode="full")
    assert calls == [("flash_attention_bshd", WINDOW),
                     ("flash_attention_bshd", 0)]
    calls.clear()
    pools, table = _paged_case(cfg, seed=8)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], 8, seed=9)
    cache = [{k: _t(v) for k, v in pools.items()}]
    forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
            cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    assert calls == [("tree_attention_paged_windowed_bshd", WINDOW),
                     ("tree_attention_paged_windowed_bshd", 0)]
    calls.clear()
    dp = bridge.draft_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_draft(jax.random.PRNGKey(1), jcfg)), cfg, "cpu")
    pool = _t(pools["k"][0].copy())
    prefix_forward(dp, cfg, torch.zeros((2, 5, cfg.d_model)),
                   _t(lens)[:, None] + torch.arange(5), cache_k=pool,
                   cache_v=pool.clone(), cache_len=_t(lens),
                   block_table=_t(table))
    assert [c[0] for c in calls] == ["tree_attention_paged_bshd"]


# ---------------------------------------------------------------------------
# generate and the engines
# ---------------------------------------------------------------------------

VOCAB = 16                 # random heads get candidates accepted


@pytest.fixture(scope="module")
def served():
    """Hydra++ at head dim 64 over a 16-token vocabulary, JAX-initialised."""
    jcfg, cfg = _cfgs(vocab_size=VOCAB)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jdp = jax_init_draft(jax.random.PRNGKey(10), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    dp = bridge.draft_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
    return jcfg, cfg, jparams, jdp, params, dp


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN] for row in np.asarray(toks)]


@pytest.mark.parametrize("spec", [True, False], ids=["hydra++", "ar"])
def test_generate_matches_jax(served, spec):
    """Prompts of 24 tokens and 20 new ones: the window binds at every
    step."""
    jcfg, cfg, jparams, jdp, params, dp = served
    tree = tree_for(cfg)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 24)).astype(
        np.int32)
    jt, jsteps, _ = jax_generate(jparams, jdp, jcfg, tree,
                                 jnp.asarray(prompt), max_new_tokens=20,
                                 max_len=MAX_LEN, use_speculative=spec)
    t, steps, acc = generate(params, dp, cfg, tree,
                             torch.from_numpy(prompt).long(),
                             max_new_tokens=20, max_len=MAX_LEN,
                             use_speculative=spec)
    assert steps == jsteps
    assert _stream(_np(t)) == _stream(jt)
    if spec:
        assert float(acc.max()) > 1.0, "no candidate was ever accepted"


@pytest.fixture(scope="module")
def serial(served):
    """JAX serial ``generate()`` per request of a ragged workload whose
    prompts pass the window; the port's serial ``generate()`` must give
    the same stream for every request."""
    jcfg, cfg, jparams, jdp, params, dp = served
    tree = tree_for(cfg)
    rs = np.random.default_rng(4)
    refs = []
    for n, budget in zip((17, 23, 30, 19, 40, 21), (12, 14, 8, 10, 13, 9)):
        prompt = rs.integers(0, VOCAB, n).astype(np.int32)
        jt, _, _ = jax_generate(jparams, jdp, jcfg, tree,
                                jnp.asarray(prompt)[None],
                                max_new_tokens=budget, max_len=MAX_LEN)
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(prompt)[None].long(),
                           max_new_tokens=budget, max_len=MAX_LEN)
        ref = _stream(jt)[0][:budget]
        assert _stream(_np(t))[0][:budget] == ref
        refs.append((prompt, budget, ref))
    return cfg, params, dp, tree, refs


@pytest.mark.parametrize("num_blocks", [None, 6])
def test_paged_engine_matches_dense_generate(serial, num_blocks):
    """Ragged prompts past the window, a dense-equivalent pool and one
    small enough to queue and preempt: every request equals JAX serial
    ``generate()`` (and so the port's) exactly."""
    cfg, params, dp, tree, refs = serial
    reqs = [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]
    # the synchronous loop: under inflight=2 admission budgets the
    # stale allowance and this pool queues without preempting
    # (tests/test_torch_engine_async.py preempts under the async loop)
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=num_blocks,
                                 inflight=1, device="cpu")
    stats = eng.serve(reqs, max_batch=4)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    assert stats.tokens_per_step > 1.0
    if num_blocks is not None:
        assert stats.preemptions >= 1
