"""zamba2-1.2b through the port against the JAX reference: Mamba2 groups
between invocations of one shared attention + MLP block, chain
speculation, and the serving engines.

Three narrow forms, fp32, params initialised in JAX (with non-trivial
Mamba2 decay rates, step biases, skips and gate norms) and converted
through ``repro_torch.bridge``:

* ``reduced()``: shared, mamba 1, shared, mamba 1 (d 256, 8 SSD heads of
  64, d_state 16, chunk 16, 4 heads over 4);
* ``every2``: 5 layers with ``hybrid_attn_every=2``, segments 2, 2, 1:
  three invocations and a remainder;
* ``heads``: ``configs.head_preserving``, 32 q over 32 kv heads of 64 (the
  shared block's published heads).

Held:

* the group program, the chain tree, the init and cache layouts (shape
  and dtype of every leaf, in bf16) and the paged pool layout match JAX's
  or follow from them (only attention groups paged); the bridge round
  trip and its refusals;
* ``forward`` full (ragged ``valid_len``) and verify against JAX at
  ``atol = rtol = 1e-4``: hidden states, logits, every cache entry and
  candidate; ``commit_cache`` with ``active`` and ``prev`` against JAX;
  every invocation reads the same storage of ``params["shared_attn"]``,
  and each invocation's KV slot holds keys of its own;
* greedy streams: ``generate()`` equals JAX's exactly; the continuous,
  paged (with a preemption) and bucketed engines, at ``inflight`` 1 and
  2, equal serial ``generate()``; chunked prefill at chunk 8 and 16 (both
  snapped to the scan's 16) equals it, dense and paged; the async engine
  equals JAX's engine (streams and step count) at ``inflight=2``;
* the launcher serves ``--arch zamba2-1.2b`` on the CPU;
* ``gpu``-marked, on the card: K1 and K2 at the shared block's heads (32
  over 32, D = 64, T = 5) and K3 at (64, 64) against their plain
  versions, fp32 and bf16.  Run there with
  ``python -m pytest --noconftest -m gpu tests/test_torch_zamba2.py``
  (that machine has no JAX; the gpu cases use none).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:     # the card's machine has no JAX: its gpu-marked cases need none
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.core.heads import init_draft_params as jax_init_draft
    from repro.core.speculative import generate as jax_generate
    from repro.models import model as jax_model
    from repro.serving import engine as jax_engine
    from repro.serving.cache import commit_cache as jax_commit
except ImportError:
    jax = jnp = jax_get_config = jax_init_draft = jax_generate = None
    jax_model = jax_engine = jax_commit = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, head_preserving, tree_for  # noqa: E402,E501
from repro_torch.core.speculative import (PAD_TOKEN, generate,  # noqa: E402
                                          init_pool_state, join_slot)
from repro_torch.core.trees import chain_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.serving.cache import commit_cache  # noqa: E402
from repro_torch.serving.engine import (BucketedEngine,  # noqa: E402
                                        PagedSpeculativeEngine, Request,
                                        SpeculativeEngine)
from repro_torch.serving.paged import (init_paged_state,  # noqa: E402
                                       paged_join_slot)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "zamba2-1.2b"
BS = 16
MAX_LEN = 128
VOCAB = 16                 # random heads get candidates accepted
FORMS = {
    "reduced": lambda c: c.reduced(),
    "every2": lambda c: dataclasses.replace(c.reduced(), n_layers=5,
                                            hybrid_attn_every=2),
    "heads": head_preserving,
}
PROGRAMS = {
    "reduced": [("shared_attn", 1), ("mamba_stack", 1)] * 2,
    "every2": [("shared_attn", 1), ("mamba_stack", 2)] * 2
    + [("shared_attn", 1), ("mamba_stack", 1)],
    "heads": [("shared_attn", 1), ("mamba_stack", 1)] * 2,
}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(form="reduced", dtype="float32", **kw):
    """(JAX cfg, port cfg) of a narrow form, plus ``kw``."""
    return [dataclasses.replace(FORMS[form](get(ARCH)), dtype=dtype, **kw)
            for get in (jax_get_config, get_config)]


def _perturb(jparams, seed=0):
    """Non-trivial Mamba2 decay rates, step biases, skips, conv biases and
    gate norms, and shared-block norms (JAX inits them constant)."""
    rs = np.random.default_rng(seed)
    u = lambda lo, hi, a: jnp.asarray(rs.uniform(lo, hi, a.shape), a.dtype)
    groups = []
    for g in jparams["groups"]:
        if "mamba" in g:
            m = dict(g["mamba"])
            for name, lo, hi in (("a_log", -1.0, 1.5), ("dt_bias", -1, 1),
                                 ("d_skip", 0.5, 1.5), ("conv_b", -.1, .1),
                                 ("norm", -.5, .5)):
                m[name] = u(lo, hi, m[name])
            g = dict(g, mamba=m, norm=u(-.3, .3, g["norm"]))
        groups.append(g)
    sp = dict(jparams["shared_attn"])
    sp["norm1"], sp["norm2"] = u(-.3, .3, sp["norm1"]), u(-.3, .3, sp["norm2"])
    return dict(jparams, groups=groups, shared_attn=sp)


def _model(form="reduced", **kw):
    """(jax cfg, port cfg, jax params, port params)."""
    jcfg, cfg = _cfgs(form, **kw)
    jparams = _perturb(jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module", params=list(FORMS))
def model(request):
    return request.param, _model(request.param)


# ---------------------------------------------------------------------------
# config, init, cache, bridge
# ---------------------------------------------------------------------------


@needs_jax
def test_full_config_and_program_match_jax():
    c, jc = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    prog = port_model.group_program(c)
    assert prog == jax_model.group_program(jc)
    assert len(prog) == 14
    assert prog == [("shared_attn", 1), ("mamba_stack", 6)] * 6 + [
        ("shared_attn", 1), ("mamba_stack", 2)]
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff,
            c.vocab_size) == (2048, 32, 32, 64, 8192, 32000)
    assert tree_for(c).parents == chain_tree(4).parents


@pytest.mark.parametrize("form", list(FORMS))
@needs_jax
def test_forms_match_jax(form):
    jc, c = _cfgs(form)
    assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert port_model.group_program(c) == jax_model.group_program(jc) \
        == PROGRAMS[form]
    assert tree_for(c).size == 5 and tree_for(c).max_depth == 4


def _layout(tree):
    flat, tdef = jax.tree_util.tree_flatten(tree)
    return tdef, [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
                  for a in flat]


@pytest.mark.parametrize("form", list(FORMS))
@needs_jax
def test_init_and_cache_layout_match_jax(form):
    """The port's own init gives JAX's tree, leaf shapes and types in bf16
    (``a_log``, ``d_skip``, ``dt_bias`` fp32; an empty dict per
    ``shared_attn`` group; one unstacked ``shared_attn`` layer), and
    init_cache JAX's layout (``ssd_state`` fp32, ``conv_win`` in the model
    dtype, a (1, B, S, Hkv, D) KV slot per invocation)."""
    jcfg, cfg = _cfgs(form, dtype="bfloat16")
    jshapes = jax.eval_shape(lambda k: jax_model.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    params = port_model.init_params(cfg, seed=0, device="cpu")
    params.pop("unembed_f32")
    assert _layout(params) == _layout(jshapes)
    for kind, g in zip(port_model.group_program(cfg), params["groups"]):
        assert (g == {}) == (kind[0] == "shared_attn")
    jc = jax_model.init_cache(jcfg, 3, 32)
    tc = init_cache(cfg, 3, 32, "cpu")
    assert _layout(tc) == _layout(jc)


@needs_jax
def test_paged_pool_pages_only_attention_groups():
    """Each shared_attn invocation gets a pool (1, N, bs, Hkv, D) of its
    own behind the one table; Mamba2 state stays per slot (B rows), in
    its own dtype and rank."""
    _, cfg = _cfgs("every2", dtype="bfloat16")
    ps = init_paged_state(port_model.init_params(cfg, device="cpu"), None,
                          cfg, 3, 9, BS, "cpu")
    H, D = cfg.n_kv_heads, cfg.head_dim
    for (kind, n), g in zip(port_model.group_program(cfg), ps.pools):
        if kind == "shared_attn":
            assert {k: tuple(v.shape) for k, v in g.items()} == \
                {"k": (1, 9, BS, H, D), "v": (1, 9, BS, H, D)}
        else:
            assert tuple(g["ssd_state"].shape) == (n, 3, 8, 16, 64)
            assert g["ssd_state"].dtype == torch.float32
            assert tuple(g["conv_win"].shape) == (n, 3, 3, 544)
            assert g["conv_win"].dtype == torch.bfloat16


@needs_jax
def test_bridge_round_trip_keeps_leaf_types():
    jcfg, cfg = _cfgs("every2", dtype="bfloat16")
    jparams = jax_model.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    m = params["groups"][1]["mamba"]
    for name in ("a_log", "d_skip", "dt_bias"):
        assert m[name].dtype == torch.float32, name
    assert m["w_in"].dtype == torch.bfloat16
    assert params["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    flat_j, tdef = jax.tree_util.tree_flatten(jparams)
    flat_t, tdef_t = jax.tree_util.tree_flatten(bridge.to_numpy(params))
    assert tdef == tdef_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@needs_jax
def test_bridge_refusals():
    jcfg, cfg = _cfgs("reduced")
    tree = jax.tree_util.tree_map(
        np.asarray, jax_model.init_params(jax.random.PRNGKey(2), jcfg))
    no_shared = {k: v for k, v in tree.items() if k != "shared_attn"}
    with pytest.raises(ValueError, match="shared_attn.*missing"):
        bridge.params_from_jax(no_shared, cfg, "cpu")
    stacked = jax.tree_util.tree_map(lambda a: np.stack([a, a]),
                                     tree["shared_attn"])
    with pytest.raises(ValueError, match="not stacked"):
        bridge.params_from_jax(dict(tree, shared_attn=stacked), cfg, "cpu")
    groups = list(tree["groups"])
    groups[1] = dict(groups[1], mamba={k: v for k, v in
                                       groups[1]["mamba"].items()
                                       if k != "dt_bias"})
    with pytest.raises(ValueError, match="dt_bias"):
        bridge.params_from_jax(dict(tree, groups=groups), cfg, "cpu")
    groups = list(tree["groups"])
    groups[0] = {"norm1": groups[1]["norm"]}
    with pytest.raises(ValueError, match="shared_attn group holds no"):
        bridge.params_from_jax(dict(tree, groups=groups), cfg, "cpu")
    groups = list(tree["groups"])
    groups[1] = {k: v for k, v in groups[1].items() if k != "mamba"}
    with pytest.raises(ValueError, match="lacks Mamba2"):
        bridge.params_from_jax(dict(tree, groups=groups), cfg, "cpu")


# ---------------------------------------------------------------------------
# forward and commit
# ---------------------------------------------------------------------------


def _assert_cache_close(tc, jc):
    assert len(tc) == len(jc)
    for g, jg in zip(tc, jc):
        assert sorted(g) == sorted(jg)
        for key in g:
            np.testing.assert_allclose(_np(g[key]), np.asarray(jg[key]),
                                       err_msg=key, **TOL)


def _prefill(m, lens, P, seed, S=64):
    """Both prefills of right-padded prompts (B, P) with ``valid_len``."""
    jcfg, cfg, jparams, params = m
    rs = np.random.default_rng(seed)
    B = len(lens)
    toks = rs.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    vl = np.asarray(lens, np.int32)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="full",
                             cache=jax_model.init_cache(jcfg, B, S),
                             valid_len=jnp.asarray(vl))
    out = forward(params, cfg, _t(toks), _t(pos), mode="full",
                  cache=init_cache(cfg, B, S, "cpu"), valid_len=_t(vl))
    return jout, out


@needs_jax
def test_forward_full_matches_jax(model):
    """A ragged prefill: the shorter row's pad tail is length-masked in the
    Mamba2 scans and its states taken at its real end."""
    _, m = model
    jout, out = _prefill(m, [40, 23], 40, seed=3)
    np.testing.assert_allclose(_np(out.hidden)[:, :23],
                               np.asarray(jout.hidden)[:, :23], **TOL)
    np.testing.assert_allclose(_np(out.logits)[0],
                               np.asarray(jout.logits)[0], **TOL)
    _assert_cache_close(out.cache, jout.cache)


def _verify(m, jout0, out0, lens, seed):
    jcfg, cfg, jparams, params = m
    tree = chain_tree(4)
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (len(lens), tree.size)).astype(
        np.int32)
    pos = (lens[:, None] + tree.depth[None]).astype(np.int32)
    tm = tree.ancestor_mask
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="verify",
                             cache=jout0.cache, cache_len=jnp.asarray(lens),
                             tree_mask=jnp.asarray(tm))
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify",
                  cache=out0.cache, cache_len=_t(lens), tree_mask=_t(tm))
    return jout, out


@needs_jax
def test_forward_verify_matches_jax(model):
    """Verify from a ragged prefill: logits, hidden states, the shared
    block's KV slots (scratch written at cache_len) and every Mamba2
    candidate; the committed Mamba2 state is left alone."""
    form, m = model
    jout0, out0 = _prefill(m, [40, 29], 40, seed=5)
    states = {gi: {k: v.clone() for k, v in g.items()}
              for gi, g in enumerate(out0.cache) if "ssd_state" in g}
    lens = np.array([40, 29], np.int32)
    jout, out = _verify(m, jout0, out0, lens, seed=6)
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    _assert_cache_close(out.cache, jout.cache)
    n = PROGRAMS[form][1][1]
    assert tuple(out.cache[1]["ssd_state"].shape) == (n, 2, 5, 8, 16, 64)
    assert tuple(out.cache[1]["conv_win"].shape) == (n, 2, 5, 3, 544)
    for gi, st in states.items():
        for key, v in st.items():
            assert torch.equal(out0.cache[gi][key], v)


@pytest.fixture(scope="module")
def verified():
    """The every2 form's ragged prefill and one verify step on both
    sides: (lens, JAX prefill, port prefill, JAX verify, port verify)."""
    m = _model("every2")
    jout0, out0 = _prefill(m, [40, 29], 40, seed=7)
    lens = np.array([40, 29], np.int32)
    jout, out = _verify(m, jout0, out0, lens, seed=8)
    return lens, jout0, out0, jout, out


def _clone(cache):
    return [{k: v.clone() for k, v in g.items()} for g in cache]


@pytest.mark.parametrize("active", [None, [True, False]])
@needs_jax
def test_commit_matches_jax(verified, active):
    """The verify forward's candidates committed with ``n_accept`` (and an
    ``active`` mask with JAX's ``prev`` restore) equal JAX's commit: the
    KV slots compacted, the Mamba2 state and window of the last accepted
    token selected."""
    lens, jout0, out0, jout, out = verified
    prev, cand = _clone(out0.cache), _clone(out.cache)
    path = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    n_acc = np.array([2, 4], np.int32)
    act = None if active is None else np.array(active)
    jc = jax_commit(jout.cache, jnp.asarray(lens), jnp.asarray(path),
                    jnp.asarray(n_acc),
                    active=None if act is None else jnp.asarray(act),
                    prev=jout0.cache)
    tc = commit_cache(cand, _t(lens), _t(path).long(), _t(n_acc),
                      active=None if act is None else _t(act), prev=prev)
    _assert_cache_close(tc, jc)
    assert tc[1] is prev[1]                          # written in place
    if act is not None:      # the inactive row keeps its committed state
        assert torch.equal(tc[1]["ssd_state"][:, 1],
                           out0.cache[1]["ssd_state"][:, 1])


@needs_jax
def test_one_weight_set_for_every_invocation(monkeypatch):
    """Each shared_attn group runs the layer of ``params["shared_attn"]``
    itself: the same storage, no per-invocation copy."""
    _, cfg, _, params = _model("every2")
    seen = []
    fn = port_model._attn_layer_fwd
    monkeypatch.setattr(port_model, "_attn_layer_fwd",
                        lambda lp, *a: seen.append(lp) or fn(lp, *a))
    forward(params, cfg, torch.randint(0, cfg.vocab_size, (1, 9)),
            torch.arange(9)[None], mode="full")
    sp = params["shared_attn"]
    assert len(seen) == 3
    for lp in seen:
        assert lp is sp
        assert lp["attn"]["wq"].data_ptr() == sp["attn"]["wq"].data_ptr()
    shared = [g for (kind, _), g in zip(port_model.group_program(cfg),
                                        params["groups"])
              if kind == "shared_attn"]
    assert shared == [{}, {}, {}]


@needs_jax
def test_each_invocation_has_its_own_kv_slot():
    """After a prefill every invocation's slot holds keys of its own (each
    sees the hidden state the Mamba2 layers before it made)."""
    cfg = _cfgs("every2")[1]
    params = port_model.init_params(cfg, seed=3, device="cpu")
    cache = init_cache(cfg, 1, 32, "cpu")
    forward(params, cfg, torch.randint(0, cfg.vocab_size, (1, 20)),
            torch.arange(20)[None], mode="full", cache=cache)
    ks = [g["k"][:, :, :20] for g in cache if "k" in g]
    assert len(ks) == 3
    for i in range(3):
        assert ks[i].abs().sum() > 0
        for j in range(i):
            assert not torch.allclose(ks[i], ks[j])


# ---------------------------------------------------------------------------
# generate and the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Per form (reduced, every2): JAX and port models over a 16-token
    vocabulary with Hydra++ heads."""
    out = {}
    for i, form in enumerate(("reduced", "every2")):
        jcfg, cfg, jparams, params = _model(form, vocab_size=VOCAB)
        jdp = jax_init_draft(jax.random.PRNGKey(10 + i), jcfg)
        dp = bridge.draft_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
        out[form] = (jcfg, cfg, jparams, jdp, params, dp)
    return out


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN]
            for row in np.asarray(toks)]


@pytest.mark.parametrize("form,spec", [("reduced", True), ("every2", True),
                                       ("reduced", False)],
                         ids=["reduced", "every2", "ar"])
@needs_jax
def test_generate_matches_jax(served, form, spec):
    jcfg, cfg, jparams, jdp, params, dp = served[form]
    tree = tree_for(cfg)
    prompt = np.random.default_rng(1).integers(0, VOCAB, (2, 20)).astype(
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


LENS = (16, 23, 32, 9, 40, 12)
BUDGETS = (30, 26, 30, 22, 30, 20)


@pytest.fixture(scope="module")
def serial(served):
    """The port's serial ``generate()`` per request of a ragged workload
    (every2 form)."""
    _, cfg, _, _, params, dp = served["every2"]
    tree = tree_for(cfg)
    rs = np.random.default_rng(9)
    refs = []
    for n, budget in zip(LENS, BUDGETS):
        prompt = rs.integers(0, VOCAB, n).astype(np.int32)
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(prompt)[None].long(),
                           max_new_tokens=budget, max_len=MAX_LEN)
        refs.append((prompt, budget, _stream(_np(t))[0][:budget]))
    return cfg, params, dp, tree, refs


def _requests(refs):
    return [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]


def _serve(eng, refs, max_batch=4):
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=max_batch)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    return stats


@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("engine,num_blocks", [("continuous", None),
                                               ("paged", None),
                                               ("paged", 8)])
@needs_jax
def test_engines_match_serial_generate(serial, engine, num_blocks, inflight):
    """Ragged prompts (bucket-padded prefill, length-masked scans) through
    the continuous engine, the paged one with a dense-equivalent pool, and
    a pool small enough to preempt and re-prefill, synchronous and with
    two steps in flight: every request equals serial ``generate()``."""
    cfg, params, dp, tree, refs = serial
    if engine == "paged":
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                     block_size=BS, num_blocks=num_blocks,
                                     inflight=inflight, device="cpu")
    else:
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                inflight=inflight, device="cpu")
    stats = _serve(eng, refs)
    assert stats.tokens_per_step > 1.0
    if num_blocks is not None:
        assert stats.preemptions >= 1
        assert eng._alloc.blocks_in_use == 0


@needs_jax
def test_bucketed_engine_matches_serial(serial):
    cfg, params, dp, tree, refs = serial
    _serve(BucketedEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                          device="cpu"), refs)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
@needs_jax
def test_chunked_prefill_matches_serial(serial, chunk, paged):
    """Chunked prefill, the chunk snapped up to the Mamba2 scan's 16: the
    KV slots written chunk by chunk, the Mamba2 state and conv window
    carried (zeroed for a first chunk)."""
    cfg, params, dp, tree, refs = serial
    kw = dict(max_len=MAX_LEN, prefill_chunk=chunk, device="cpu")
    eng = (PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS, **kw)
           if paged else SpeculativeEngine(params, dp, cfg, tree, **kw))
    assert eng.prefill_chunk == 16 and eng._view_grows
    stats = _serve(eng, refs)
    assert stats.prefill_chunks > len(refs)


@needs_jax
def test_engine_rules_match_jax(serial):
    """The chunk snap and whether a chunk's view grows, as JAX's engine
    decides them: zamba2's shared block grows it, a pure Mamba2 stack
    does not."""
    cfg, params, dp, tree, _ = serial
    pure = dataclasses.replace(cfg, hybrid_attn_every=0, n_layers=2)
    jpure = dataclasses.replace(_cfgs("every2", vocab_size=VOCAB)[0],
                                hybrid_attn_every=0, n_layers=2)
    assert port_model.group_program(pure) == [("mamba_stack", 2)]
    for c, jc, p in ((cfg, _cfgs("every2", vocab_size=VOCAB)[0], params),
                     (pure, jpure, port_model.init_params(pure,
                                                          device="cpu"))):
        eng = SpeculativeEngine(p, None, c, tree, prefill_chunk=20,
                                device="cpu")
        jeng = jax_engine.SpeculativeEngine(None, None, jc, tree,
                                            prefill_chunk=20)
        assert (eng.prefill_chunk, eng._view_grows) == \
            (jeng.prefill_chunk, jeng._view_grows)
    assert not SpeculativeEngine(
        port_model.init_params(pure, device="cpu"), None, pure, tree,
        device="cpu")._view_grows


@needs_jax
def test_paged_join_equals_dense_join(serial):
    """One prompt joined into slot 1 of a dense pool and of a paged pool:
    the Mamba2 rows (fp32 state, model-dtype window) are equal bit for
    bit, the other slots untouched, and each invocation's pool holds the
    dense slot's keys at the table's blocks."""
    cfg, params, dp, tree, refs = serial
    prompt = torch.from_numpy(refs[4][0]).long()
    P = prompt.shape[0]
    dense = join_slot(params, dp, cfg, init_pool_state(
        params, dp, cfg, 3, MAX_LEN, "cpu"), prompt, P, 1)
    M = MAX_LEN // BS
    table = torch.zeros(M, dtype=torch.int32)
    table[:3] = torch.tensor([5, 2, 7])
    paged = paged_join_slot(params, dp, cfg, init_paged_state(
        params, dp, cfg, 3, 9, BS, "cpu"), prompt, P, 1, table)
    for (kind, _), g, pg in zip(port_model.group_program(cfg), dense.cache,
                                paged.pools):
        for key in g:
            if kind == "shared_attn":
                view = pg[key][:, table.long()].reshape(1, M * BS,
                                                        *g[key].shape[3:])
                assert torch.equal(view[:, :P], g[key][:, 1, :P])
            else:
                assert torch.equal(pg[key], g[key])
                assert pg[key][:, 1].abs().sum() > 0
                assert not pg[key][:, [0, 2]].any()
    assert int(paged.cache_len[1]) == P
    assert torch.equal(paged.last_token, dense.last_token)


@pytest.mark.parametrize("paged", [False, True])
@needs_jax
def test_async_engine_matches_jax_engine(served, paged):
    """The async engine (``inflight=2``) against JAX's engine on the
    reduced form: streams, steps, preemptions (the paged pool forces
    one)."""
    jcfg, cfg, jparams, jdp, params, dp = served["reduced"]
    tree = tree_for(cfg)
    rs = np.random.RandomState(21)
    lens, budgets = (16, 23, 9, 40), (24, 30, 10, 20)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    kw = dict(max_len=MAX_LEN, inflight=2)
    if paged:
        jeng = jax_engine.PagedSpeculativeEngine(
            jparams, jdp, jcfg, tree, block_size=BS, num_blocks=7, **kw)
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS,
                                     num_blocks=7, device="cpu", **kw)
    else:
        jeng = jax_engine.SpeculativeEngine(jparams, jdp, jcfg, tree, **kw)
        eng = SpeculativeEngine(params, dp, cfg, tree, device="cpu", **kw)
    jreqs = [jax_engine.Request(prompt=p.copy(), max_new_tokens=b)
             for p, b in zip(prompts, budgets)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    jstats = jeng.serve(jreqs, max_batch=3)
    stats = eng.serve(reqs, max_batch=3)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert stats.steps == jstats.steps
    assert stats.steps_in_flight == jstats.steps_in_flight == 2
    assert stats.preemptions == jstats.preemptions
    if paged:
        assert stats.preemptions >= 1


@pytest.mark.parametrize("engine,extra", [("paged", []),
                                          ("continuous", ["--prefill-chunk",
                                                          "16"]),
                                          ("bucketed", [])])
def test_serve_launcher_on_the_cpu(capsys, engine, extra):
    serve.main(["--arch", ARCH, "--engine", engine, "--batch", "2",
                "--requests", "3", "--prompt-len", "20", "--ragged",
                "--max-new-tokens", "5", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert f"[serve] arch={ARCH}-smoke tree=5 (chain=True)" in out
    # 3 requests x 5 tokens, the first of each from its prefill
    assert f"[serve] engine={engine} " in out and "tokens=12 " in out


# ---------------------------------------------------------------------------
# on the card: the kernels at the shared block's shapes
# ---------------------------------------------------------------------------


def _k1_case(dtype, seed=0, B=4, H=32, D=64, T=5, lens=(0, 37, 100, 150)):
    """K1/K2 operands at the shared block's heads (H over H, D = 64, a
    chain of T): a paged pool of 16-position blocks with a NULL hole, its
    dense view, the chain mask."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).to("cuda", dtype)
    need = [-(-(n + T) // BS) for n in lens]
    M = max(need) + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = torch.arange(nxt, nxt + n)
        nxt += n
    table[2, 1] = 0
    pk, pv = r(nxt, BS, H, D), r(nxt, BS, H, D)
    pk[0] = pv[0] = float("nan")
    q, tk, tv = r(B, T, H, D), r(B, T, H, D), r(B, T, H, D)
    tm = torch.ones((T, T), dtype=torch.bool).tril().cuda()
    cl = torch.tensor(lens, dtype=torch.int32).cuda()
    table = table.cuda()
    dk = torch.nan_to_num(pk)[table.long()].reshape(B, M * BS, H, D)
    dv = torch.nan_to_num(pv)[table.long()].reshape(B, M * BS, H, D)
    return (q, pk, pv, tk, tv, tm, cl, table), (q, dk, dv, tk, tv, tm, cl)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_tree_verify_at_the_shared_block(monkeypatch, dtype, tol):
    """K1 and K2 at 32 q over 32 kv heads, D = 64, T = 5 (padded to 8 by
    the wrappers) against their plain versions; two calls bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.tree_attention import dense_ops, ops
    from repro_torch.kernels.tree_attention.kernel import (
        tree_attention_dense_plain, tree_attention_paged_plain)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    paged, dense = _k1_case(getattr(torch, dtype))
    for what, run, ref in (
            ("K1", lambda: ops.tree_attention_paged_bshd(*paged),
             tree_attention_paged_plain(*paged)),
            ("K2", lambda: dense_ops.tree_attention_bshd(*dense),
             tree_attention_dense_plain(*dense))):
        out, again = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(out, again), what
        assert torch.isfinite(out).all(), what
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol, msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S", [37, 300])
def test_cuda_flash_attention_at_head_dim_64(monkeypatch, dtype, tol, S):
    """K3 at (64, 64), 32 over 32 heads, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn((1, S, 32, 64), generator=g).to(
        "cuda", getattr(torch, dtype)) for _ in range(3))
    out = ops.flash_attention_bshd(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
