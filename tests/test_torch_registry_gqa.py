"""The rest of the attention registry through the port against the JAX
reference: deepseek-moe-16b (GQA 16 over 16 under the DeepSeek MoE),
starcoder2-7b (36 q over 4 kv heads), qwen2.5-32b (40 over 8, QKV bias)
and chameleon-34b (64 over 8, an early-fusion VLM over token ids).

* each config registers with the JAX config's fields, ``reduced()`` and
  group program, and decodes with ``default_tree(16, 4, 4)``;
* at its head-preserving narrow form (``configs.head_preserving``: the
  published head counts, 2 layers, d_model 256, head_dim 64, small FFN,
  experts and vocabulary, fp32), params JAX-initialised and converted
  through ``repro_torch.bridge``, with qwen's ``bq``/``bk``/``bv`` (and
  its prefix layer's) set non-zero from a numpy seed (JAX inits them to
  zeros): ``forward`` in full, dense-verify and paged-verify mode matches
  JAX ``forward`` within ``atol = rtol = 1e-4`` (hidden states, logits,
  caches).  A verify step of 16 tree tokens then has 80, 128 and 144
  query rows per kv head at qwen, chameleon and starcoder2: past the 64
  one block of the tree-verify kernel holds, so the kernel's row groups
  are on the path (the CPU runs its plain version);
* prefill runs K3 on every layer, paged verify K1 and dense verify K2;
* greedy Hydra++ ``generate()`` streams equal JAX ``generate()`` exactly
  (a 16-token vocabulary, so random heads get candidates accepted), and
  the paged engine equals JAX serial ``generate()`` request by request
  with a pool small enough to force a preemption (deepseek-moe-16b
  while routing stays under each expert's capacity, as in
  ``tests/test_torch_chunked_prefill.py``: batchmates decide which
  tokens overflow);
* so does the paged engine with chunked prefill (chunks of 8: the
  continuation branch of ``gqa_fwd`` through K3's chunk form);
* the bridge refuses GQA projections or biases that do not match the
  config;
* the launcher serves each reduced config on the CPU.
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
from repro_torch.configs import (get_config, head_preserving,  # noqa: E402
                                 tree_for)
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
ARCHS = ("deepseek-moe-16b", "starcoder2-7b", "qwen2.5-32b", "chameleon-34b")
# query rows per kv head of a 16-token verify step
ROWS = {"deepseek-moe-16b": 16, "starcoder2-7b": 144, "qwen2.5-32b": 80,
        "chameleon-34b": 128}
BS = 16
MAX_LEN = 128
VOCAB = 16                 # random heads get candidates accepted
# the serial workload: ragged prompts and budgets, and a pool of 5 usable
# blocks that makes the slots' growth preempt
LENS, BUDGETS, NUM_BLOCKS = (9, 12, 10, 14), (14, 12, 13, 12), 6


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg): the head-preserving narrow form in fp32."""
    return [dataclasses.replace(head_preserving(get(arch)), dtype="float32",
                                **kw)
            for get in (jax_get_config, get_config)]


def _set_biases(jtree, seed):
    """QKV biases drawn from a numpy seed into every GQA attention of a
    JAX param tree that has them (the groups' and the prefix layer's)."""
    rs = np.random.default_rng(seed)

    def visit(node):
        if isinstance(node, dict):
            if "bq" in node:
                for key in ("bq", "bk", "bv"):
                    node[key] = jnp.asarray(0.5 * rs.standard_normal(
                        node[key].shape, dtype=np.float32))
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)

    visit(jtree)
    return jtree


def _model(arch, **kw):
    """(jax cfg, port cfg, jax params, jax draft, port params, port
    draft), JAX-initialised (non-zero QKV biases where the config has
    them)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = _set_biases(jax_model.init_params(jax.random.PRNGKey(0), jcfg),
                          seed=1)
    jdp = _set_biases(jax_init_draft(jax.random.PRNGKey(1), jcfg), seed=2)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    dp = bridge.draft_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
    return jcfg, cfg, jparams, jdp, params, dp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return request.param, _model(request.param)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The narrow form over a 16-token vocabulary, and the JAX serial
    ``generate()`` stream of each request of the workload (the port's
    serial ``generate()`` must give the same)."""
    arch = request.param
    jcfg, cfg, jparams, jdp, params, dp = _model(arch, vocab_size=VOCAB)
    tree = tree_for(cfg)
    rs = np.random.default_rng(4)
    refs = []
    for n, budget in zip(LENS, BUDGETS):
        prompt = rs.integers(0, VOCAB, n).astype(np.int32)
        jt, _, _ = jax_generate(jparams, jdp, jcfg, tree,
                                jnp.asarray(prompt)[None],
                                max_new_tokens=budget, max_len=MAX_LEN)
        refs.append((prompt, budget, _stream(jt)[0][:budget]))
    return arch, (jcfg, cfg, jparams, jdp, params, dp, tree, refs)


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN]
            for row in np.asarray(toks)]


# ---------------------------------------------------------------------------
# configs and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_registers_with_jax_fields(arch):
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(jfull.reduced())
    narrow, jnarrow = _cfgs(arch)[::-1]
    assert dataclasses.asdict(narrow) == dataclasses.asdict(jnarrow)
    assert (narrow.n_heads, narrow.n_kv_heads) == (full.n_heads,
                                                   full.n_kv_heads)
    for c, jc in ((full, jfull), (narrow, jnarrow)):
        assert port_model.group_program(c) == jax_model.group_program(jc)
    tree, want = tree_for(full), default_tree(16, 4, 4)
    np.testing.assert_array_equal(tree.ancestor_mask, want.ancestor_mask)
    np.testing.assert_array_equal(tree.depth, want.depth)
    # 16 tree tokens over the kv head's query heads
    assert full.q_per_kv * tree.depth.shape[0] == ROWS[arch]


def test_init_and_cache_layout_match_jax(model):
    """The port's own init gives JAX's tree, leaf shapes and types in
    bf16 (QKV biases where the config has them; the MoE router fp32), and
    ``init_cache`` JAX's cache shapes."""
    arch, _ = model
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs(arch))
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
    _, (jcfg, cfg, jparams, jdp, params, dp) = model
    for jtree, tree in ((jparams, params), (jdp, dp)):
        back = bridge.to_numpy(tree)
        flat_j, tdef = jax.tree_util.tree_flatten(jtree)
        flat_t, tdef_t = jax.tree_util.tree_flatten(back)
        assert tdef == tdef_t
        for a, b in zip(flat_j, flat_t):
            np.testing.assert_array_equal(np.asarray(a), b)
    if cfg.qkv_bias:    # the biases arrive non-zero, in groups and prefix
        for attn in (params["groups"][0]["attn"], dp["prefix"]["attn"]):
            assert all(bool(attn[k].abs().min() > 0)
                       for k in ("bq", "bk", "bv"))


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "starcoder2-7b"])
def test_bridge_checks_gqa_layout(arch):
    jcfg, cfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    attn = tree["groups"][0]["attn"]
    cut = dict(attn, wk=attn["wk"][..., :-64])
    with pytest.raises(ValueError, match="wk must be"):
        bridge.params_from_jax(dict(tree, groups=[dict(
            tree["groups"][0], attn=cut)]), cfg, "cpu")
    if cfg.qkv_bias:
        lacking = {k: v for k, v in attn.items() if k != "bk"}
        with pytest.raises(ValueError, match="attention has"):
            bridge.params_from_jax(dict(tree, groups=[dict(
                tree["groups"][0], attn=lacking)]), cfg, "cpu")
    jdp = jax.tree_util.tree_map(
        np.asarray, jax_init_draft(jax.random.PRNGKey(1), jcfg))
    pa = jdp["prefix"]["attn"]
    with pytest.raises(ValueError, match="prefix wq must be"):
        bridge.draft_params_from_jax(dict(jdp, prefix=dict(
            jdp["prefix"], attn=dict(pa, wq=pa["wq"][:, :-64]))), cfg,
            "cpu")


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
    """The config's own tree (16 tokens), tokens and positions."""
    rs = np.random.default_rng(seed)
    tree = tree_for(cfg)
    T = tree.depth.shape[0]
    toks = rs.integers(0, cfg.vocab_size, (len(lens), T)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + tree.depth[None, :]).astype(np.int32)
    return tree.ancestor_mask, toks, pos, np.asarray(lens, np.int32)


def test_forward_full_matches_jax(model):
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
    """K/V pools per group with a poisoned NULL block, ragged lens and a
    NULL hole below cache_len."""
    rs = np.random.default_rng(seed)
    N, hd = 12, cfg.resolved_head_dim
    shape = lambda n: (n, N, BS, cfg.n_kv_heads, hd)
    pools = [{k: rs.standard_normal(shape(n), dtype=np.float32)
              for k in ("k", "v")}
             for _, n in port_model.group_program(cfg)]
    for g in pools:
        for p in g.values():
            p[:, 0] = 1e4                       # NULL garbage
    table = np.array([[1, 2, 3, 4, 0], [0, 5, 6, 7, 8]], np.int32)
    return pools, table


def test_forward_paged_verify_matches_jax(model):
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


def test_kernels_each_path_takes(monkeypatch, model):
    """Prefill: K3 on every layer.  Paged verify: K1 on every layer, never
    K4 or K5, each call at the config's query rows per kv head; dense
    verify: K2 on every layer."""
    arch, (_, cfg, _, _, params, _) = model
    calls = []
    for name in ("flash_attention_bshd", "tree_attention_paged_bshd",
                 "tree_attention_paged_windowed_bshd",
                 "mla_attention_paged_bshd", "tree_attention_bshd"):
        fn = getattr(attn_mod, name)
        monkeypatch.setattr(
            attn_mod, name, lambda *a, _n=name, _f=fn, **kw: calls.append(
                (_n, (a[0].shape[2] // a[1].shape[-2]) * a[0].shape[1]))
            or _f(*a, **kw))
    toks = torch.randint(0, cfg.vocab_size, (1, 24))
    forward(params, cfg, toks, torch.arange(24)[None], mode="full")
    assert [n for n, _ in calls] == ["flash_attention_bshd"] * cfg.n_layers
    calls.clear()
    pools, table = _paged_case(cfg, seed=8)
    tm, toks, pos, lens = _verify_inputs(cfg, [37, 55], seed=9)
    cache = [{k: _t(v) for k, v in g.items()} for g in pools]
    forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=cache,
            cache_len=_t(lens), tree_mask=_t(tm), block_table=_t(table))
    assert calls == [("tree_attention_paged_bshd", ROWS[arch])] * \
        cfg.n_layers
    calls.clear()
    dense = init_cache(cfg, 2, 64, "cpu")
    forward(params, cfg, _t(toks), _t(pos), mode="verify", cache=dense,
            cache_len=_t(lens), tree_mask=_t(tm))
    assert calls == [("tree_attention_bshd", ROWS[arch])] * cfg.n_layers


# ---------------------------------------------------------------------------
# generate and the paged engine
# ---------------------------------------------------------------------------


def test_generate_matches_jax(served):
    _, (jcfg, cfg, jparams, jdp, params, dp, tree, _) = served
    prompt = np.random.default_rng(3).integers(0, VOCAB, (2, 20)).astype(
        np.int32)
    jt, jsteps, _ = jax_generate(jparams, jdp, jcfg, tree,
                                 jnp.asarray(prompt), max_new_tokens=16,
                                 max_len=MAX_LEN)
    t, steps, acc = generate(params, dp, cfg, tree,
                             torch.from_numpy(prompt).long(),
                             max_new_tokens=16, max_len=MAX_LEN)
    assert steps == jsteps
    assert _stream(_np(t)) == _stream(jt)
    assert float(acc.max()) > 1.0, "no candidate was ever accepted"


def test_serial_generate_matches_jax(served):
    _, (_, cfg, _, _, params, dp, tree, refs) = served
    for prompt, budget, ref in refs:
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(prompt)[None].long(),
                           max_new_tokens=budget, max_len=MAX_LEN)
        assert _stream(_np(t))[0][:budget] == ref


def test_paged_engine_matches_jax_serial_generate(served):
    """Ragged prompts through a pool small enough to preempt: every
    request equals JAX serial ``generate()`` exactly."""
    _, (_, cfg, _, _, params, dp, tree, refs) = served
    reqs = [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]
    # the synchronous loop: under inflight=2 admission budgets the stale
    # allowance and a pool this small queues instead of preempting
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=NUM_BLOCKS,
                                 inflight=1, device="cpu")
    stats = eng.serve(reqs, max_batch=4)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    assert stats.tokens_per_step > 1.0
    assert stats.preemptions >= 1
    assert eng._alloc.blocks_in_use == 0


def test_chunked_paged_engine_matches_jax_serial_generate(served):
    """Chunked prefill (chunks of 8: every prompt in 2 chunks, the
    continuation branch of ``gqa_fwd`` at the published head counts)
    through the same pool: every request still equals JAX serial
    ``generate()``."""
    _, (_, cfg, _, _, params, dp, tree, refs) = served
    reqs = [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=NUM_BLOCKS,
                                 inflight=1, prefill_chunk=8, device="cpu")
    stats = eng.serve(reqs, max_batch=4)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    assert stats.prefill_chunks >= 2 * len(reqs)
    assert eng._alloc.blocks_in_use == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--engine", "paged", "--batch", "2",
                "--requests", "3", "--prompt-len", "12", "--ragged",
                "--max-new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] arch={arch}-smoke " in out
    assert "[serve] engine=paged " in out and "tokens=12 " in out
