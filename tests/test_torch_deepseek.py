"""deepseek-v2-lite-16b through the port against the JAX reference: MLA
(latent KV cache, absorbed verify through K5) and the fine-grained MoE.

A reduced deepseek-v2-lite-16b (2 layers: one dense, one MoE; d 256, 4
heads, latent rank 64, rope dim 16; 4 routed experts top-2 plus 1 shared;
fp32), params initialised in JAX and converted through
``repro_torch.bridge``, as ``tests/test_mla_prefill.py`` builds it:

* the config, the group program and the cache layout are JAX's; the
  port's own init gives JAX's leaf shapes and types;
* the bridge round-trips the two groups exactly;
* ``forward`` in full mode (prefill), dense verify and paged verify mode
  matches JAX ``forward`` within ``atol = rtol = 1e-4`` (hidden states,
  logits, the latent caches); the JAX paged path runs its MLA Pallas
  kernel in interpret mode, the port K5's plain version;
* prefill goes through K3 on every layer, paged verify through K5 on
  every layer, the Hydra++ prefix layer (GQA) through K1;
* ``generate()`` greedy streams equal JAX ``generate()`` exactly under
  Hydra++, Medusa and autoregressive decoding, and the port's paged
  engine equals JAX serial ``generate()`` request by request on six
  ragged prompts, with a pool small enough to force preemption;
* the launcher serves the reduced config on the CPU.
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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v2-lite-16b"
BS = 16
MAX_LEN = 128
VOCAB = 16                 # random heads get candidates accepted
DRAFTS = {
    "hydra++": {},
    "medusa": dict(kind="medusa", n_mlp_layers=1, prefix_attention=False),
}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfgs(**kw):
    """(JAX cfg, port cfg): reduced deepseek-v2-lite-16b in fp32, plus
    ``kw``."""
    return [dataclasses.replace(get(ARCH).reduced(), dtype="float32", **kw)
            for get in (jax_get_config, get_config)]


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def test_configs_and_groups_match_jax():
    for c, jc in ((get_config(ARCH), jax_get_config(ARCH)), _cfgs()[::-1]):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert port_model.group_program(c) == jax_model.group_program(jc)
    full = get_config(ARCH)
    assert port_model.group_program(full) == [("attn_stack_dense", 1),
                                              ("attn_stack_moe", 26)]
    assert (full.mla.kv_lora_rank, full.mla.qk_rope_dim, full.moe.n_routed,
            full.moe.top_k, full.d_ff) == (512, 64, 64, 6, 1408)


def test_init_and_cache_layout_match_jax():
    """The port's own init gives JAX's tree, leaf shapes and types (the
    router fp32 in a bf16 model), and init_cache JAX's latent caches."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    jshapes = jax.eval_shape(lambda k: jax_model.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    params = port_model.init_params(cfg, seed=0, device="cpu")
    params.pop("unembed_f32")
    flat_j, tdef = jax.tree_util.tree_flatten(jshapes)
    flat_t, tdef_t = jax.tree_util.tree_flatten(params)
    assert tdef == tdef_t
    for a, b in zip(flat_j, flat_t):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    jc = jax_model.init_cache(jcfg, 3, 32)
    tc = init_cache(cfg, 3, 32, "cpu")
    assert [{k: tuple(v.shape) for k, v in g.items()} for g in tc] == \
        [{k: tuple(v.shape) for k, v in g.items()} for g in jc]


def test_bridge_round_trip(model):
    jcfg, cfg, jparams, params = model
    back = bridge.to_numpy(params)
    flat_j, tdef = jax.tree_util.tree_flatten(jparams)
    flat_t, tdef_t = jax.tree_util.tree_flatten(back)
    assert tdef == tdef_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bridge_checks_each_group(model):
    jcfg, cfg, jparams, params = model
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError, match="2 groups"):
        bridge.params_from_jax(dict(tree, groups=tree["groups"][:1]), cfg,
                               "cpu")
    swapped = dict(tree, groups=tree["groups"][::-1])
    with pytest.raises(ValueError, match="FFN"):
        bridge.params_from_jax(swapped, cfg, "cpu")


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


def test_forward_full_matches_jax(model):
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
    """Latent pools per group with a poisoned NULL block, ragged lens and
    a NULL hole below cache_len."""
    m = cfg.mla
    rs = np.random.default_rng(seed)
    N = 12
    pools = [{"k": rs.standard_normal((n, N, BS, m.kv_lora_rank),
                                      dtype=np.float32),
              "v": rs.standard_normal((n, N, BS, m.qk_rope_dim),
                                      dtype=np.float32)}
             for _, n in port_model.group_program(cfg)]
    for g in pools:
        for p in g.values():
            p[:, 0] = 1e4                       # NULL garbage
    table = np.array([[1, 2, 3, 0, 0], [0, 4, 5, 6, 0]], np.int32)
    return pools, table


def test_forward_paged_verify_matches_jax(model):
    jcfg, cfg, jparams, params = model
    pools, table = _paged_case(cfg, seed=6)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], 8, seed=7)
    jout = jax_model.forward(
        jparams, jcfg, jnp.asarray(toks), jnp.asarray(pos), mode="verify",
        cache=[{k: jnp.asarray(v) for k, v in g.items()} for g in pools],
        cache_len=jnp.asarray(lens), tree_mask=jnp.asarray(tm),
        block_table=jnp.asarray(table))
    cache = [{k: _t(v.copy()) for k, v in g.items()} for g in pools]
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
                  cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    _assert_outputs_match(out, jout)


def test_kernels_each_path_takes(monkeypatch, model):
    """Prefill: K3 on every layer.  Paged verify: K5 on every layer and
    never K1/K4; the Hydra++ prefix layer: K1."""
    jcfg, cfg, jparams, params = model
    calls = []
    for name in ("flash_attention_bshd", "tree_attention_paged_bshd",
                 "tree_attention_paged_windowed_bshd",
                 "mla_attention_paged_bshd"):
        fn = getattr(attn_mod, name)
        monkeypatch.setattr(attn_mod, name,
                            lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    toks = torch.randint(0, cfg.vocab_size, (1, 24))
    forward(params, cfg, toks, torch.arange(24)[None], mode="full")
    assert calls == ["flash_attention_bshd"] * cfg.n_layers
    calls.clear()
    pools, table = _paged_case(cfg, seed=8)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], 8, seed=9)
    cache = [{k: _t(v) for k, v in g.items()} for g in pools]
    forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
            cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    assert calls == ["mla_attention_paged_bshd"] * cfg.n_layers
    calls.clear()
    dp = bridge.draft_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_init_draft(jax.random.PRNGKey(1), jcfg)), cfg, "cpu")
    shape = (12, BS, cfg.n_kv_heads, cfg.resolved_head_dim)
    prefix_forward(dp, cfg, torch.zeros((2, 5, cfg.d_model)),
                   _t(lens)[:, None] + torch.arange(5),
                   cache_k=torch.zeros(shape), cache_v=torch.zeros(shape),
                   cache_len=_t(lens), block_table=_t(table))
    assert calls == ["tree_attention_paged_bshd"]


# ---------------------------------------------------------------------------
# generate and the paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Per draft kind: JAX and port models over a 16-token vocabulary."""
    out = {}
    jparams = params = None
    for i, (draft, kw) in enumerate(DRAFTS.items()):
        jcfg, cfg = (dataclasses.replace(
            c, draft=dataclasses.replace(c.draft, **kw))
            for c in _cfgs(vocab_size=VOCAB))
        if jparams is None:
            jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
            params = bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        jdp = jax_init_draft(jax.random.PRNGKey(10 + i), jcfg)
        dp = bridge.draft_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
        out[draft] = (jcfg, cfg, jparams, jdp, params, dp)
    return out


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN]
            for row in np.asarray(toks)]


@pytest.mark.parametrize("draft,spec", [("hydra++", True), ("medusa", True),
                                        ("hydra++", False)],
                         ids=["hydra++", "medusa", "ar"])
def test_generate_matches_jax(served, draft, spec):
    jcfg, cfg, jparams, jdp, params, dp = served[draft]
    tree = tree_for(cfg)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 20)).astype(
        np.int32)
    jt, jsteps, _ = jax_generate(jparams, jdp, jcfg, tree,
                                 jnp.asarray(prompt), max_new_tokens=16,
                                 max_len=MAX_LEN, use_speculative=spec)
    t, steps, acc = generate(params, dp, cfg, tree,
                             torch.from_numpy(prompt).long(),
                             max_new_tokens=16, max_len=MAX_LEN,
                             use_speculative=spec)
    assert steps == jsteps
    assert _stream(_np(t)) == _stream(jt)
    if spec:
        assert float(acc.max()) > 1.0, "no candidate was ever accepted"


@pytest.fixture(scope="module")
def serial(served):
    """JAX serial ``generate()`` per request of a ragged workload; the
    port's serial ``generate()`` must give the same stream for every
    request."""
    jcfg, cfg, jparams, jdp, params, dp = served["hydra++"]
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
    """Ragged prompts, a dense-equivalent pool and one small enough to
    queue and preempt: every request equals JAX serial ``generate()``
    (and so the port's) exactly."""
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


def test_serve_launcher_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--engine", "paged", "--batch", "2",
                "--requests", "3", "--prompt-len", "12", "--ragged",
                "--max-new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] arch={ARCH}-smoke " in out
    assert "[serve] engine=paged " in out and "tokens=12 " in out
