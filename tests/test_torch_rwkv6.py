"""rwkv6-1.6b through the port against the JAX reference: the RWKV6
recurrent stack, its prefill through K6 (its plain version here), its
per-token verify scan, the state commit and chain speculation.

A reduced rwkv6-1.6b (2 layers, d 256, 4 wkv heads of 64, d_ff 512,
chunk 16; fp32), params initialised in JAX and converted through
``repro_torch.bridge``:

* the config, the group program, the chain tree and the cache layout are
  JAX's; the port's own init gives JAX's leaf shapes and types (``w0``,
  ``u_bonus``, ``gn_gamma``, ``gn_beta`` fp32 in a bf16 model), and the
  bridge round-trips the group exactly, keeping those types;
* ``forward`` in full mode (a ragged ``valid_len``) and in verify mode
  matches JAX ``forward`` within ``atol = rtol = 1e-4``: hidden states,
  logits, the committed final states and every per-token candidate;
  verify leaves the committed state alone; the prefill runs the K6
  wrapper on every layer, verify never;
* ``commit_cache`` with an ``active`` mask equals JAX's commit with its
  ``prev`` restore, and writes the active rows only;
* ``generate()`` greedy streams equal JAX ``generate()`` exactly under
  Hydra++, Medusa and autoregressive decoding with the chain tree;
* the continuous and paged engines equal JAX serial ``generate()``
  request by request on ragged (bucket-padded) prompts, the paged one
  also with a pool small enough to force preemption and re-prefill;
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
from repro.serving.cache import commit_cache as jax_commit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.core.trees import chain_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.model import forward, init_cache  # noqa: E402
from repro_torch.serving.cache import commit_cache  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request, SpeculativeEngine)

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "rwkv6-1.6b"
STATE_KEYS = ("wkv_state", "shift_tm", "shift_cm")
BS = 16
MAX_LEN = 128
VOCAB = 16                 # random heads get candidates accepted
DRAFTS = {
    "hydra++": {},
    "medusa": dict(kind="medusa", n_mlp_layers=1),
}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    """(JAX cfg, port cfg): reduced rwkv6-1.6b in fp32, plus ``kw``."""
    return [dataclasses.replace(get(ARCH).reduced(), dtype="float32", **kw)
            for get in (jax_get_config, get_config)]


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _cfgs()
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    # non-trivial mixes, bonus and decay base, so every term is exercised
    rs = np.random.default_rng(0)
    g = dict(jparams["groups"][0])
    rw = dict(g["rwkv"])
    for name in ("tm_mu_x", "tm_mu", "u_bonus", "cm_mu_k", "cm_mu_r"):
        rw[name] = jnp.asarray(rs.uniform(-0.5, 0.5, rw[name].shape),
                               rw[name].dtype)
    rw["w0"] = jnp.asarray(rs.uniform(-3, 0, rw["w0"].shape), jnp.float32)
    g["rwkv"] = rw
    jparams = dict(jparams, groups=[g])
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


# ---------------------------------------------------------------------------
# config, init, cache, bridge
# ---------------------------------------------------------------------------


def test_configs_groups_and_tree_match_jax():
    for c, jc in ((get_config(ARCH), jax_get_config(ARCH)), _cfgs()[::-1]):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert port_model.group_program(c) == jax_model.group_program(jc)
    full = get_config(ARCH)
    assert port_model.group_program(full) == [("rwkv_stack", 24)]
    assert (full.d_model, full.n_heads, full.d_ff, full.vocab_size) == \
        (2048, 32, 7168, 65536)
    assert 1.3e9 < full.n_params < 1.45e9
    assert tree_for(full).parents == chain_tree(4).parents


def test_init_and_cache_layout_match_jax():
    """The port's own init gives JAX's tree, leaf shapes and types (fp32
    decay base, bonus and GroupNorm affine in a bf16 model), and
    init_cache JAX's state layout and types."""
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
    assert [{k: (tuple(v.shape), str(v.dtype)) for k, v in g.items()}
            for g in jc] == \
        [{k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for k, v in g.items()} for g in tc]


def test_bridge_round_trip_keeps_leaf_types():
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    jparams = jax_model.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    rw = params["groups"][0]["rwkv"]
    for name in ("w0", "u_bonus", "gn_gamma", "gn_beta"):
        assert rw[name].dtype == torch.float32, name
    assert rw["wr"].dtype == torch.bfloat16
    flat_j, tdef = jax.tree_util.tree_flatten(jparams)
    flat_t, tdef_t = jax.tree_util.tree_flatten(bridge.to_numpy(params))
    assert tdef == tdef_t
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_bridge_checks_the_group(model):
    jcfg, cfg, jparams, params = model
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError, match="1 groups"):
        bridge.params_from_jax(dict(tree, groups=tree["groups"] * 2), cfg,
                               "cpu")
    g = {k: v for k, v in tree["groups"][0].items() if k != "rwkv"}
    with pytest.raises(ValueError, match="RWKV6"):
        bridge.params_from_jax(dict(tree, groups=[g]), cfg, "cpu")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _assert_outputs_match(out, jout):
    np.testing.assert_allclose(_np(out.hidden), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(_np(out.logits), np.asarray(jout.logits),
                               **TOL)
    for key in STATE_KEYS:
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def _prefill(model, lens, P, seed):
    """Both prefills of right-padded prompts (B, P) with ``valid_len``."""
    jcfg, cfg, jparams, params = model
    rs = np.random.default_rng(seed)
    B = len(lens)
    toks = rs.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    vl = np.asarray(lens, np.int32)
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="full",
                             cache=jax_model.init_cache(jcfg, B, 64),
                             valid_len=jnp.asarray(vl))
    out = forward(params, cfg, _t(toks), _t(pos), mode="full",
                  cache=init_cache(cfg, B, 64, "cpu"), valid_len=_t(vl))
    return jout, out


def test_forward_full_matches_jax(model):
    """A ragged prefill: the shorter row's pad tail is length-masked, and
    its states are taken at its real end."""
    jout, out = _prefill(model, [40, 23], 40, seed=3)
    np.testing.assert_allclose(_np(out.hidden)[:, :23],
                               np.asarray(jout.hidden)[:, :23], **TOL)
    np.testing.assert_allclose(_np(out.logits)[0], np.asarray(jout.logits)[0],
                               **TOL)
    for key in STATE_KEYS:
        np.testing.assert_allclose(_np(out.cache[0][key]),
                                   np.asarray(jout.cache[0][key]), **TOL)


def test_valid_len_equals_the_exact_length_prefill(model):
    """The masked pad tail leaves the states of a bucket-padded prefill
    those of the exact-length one (within rounding: the row's other
    operations run at another length)."""
    jcfg, cfg, jparams, params = model
    rs = np.random.default_rng(4)
    toks = rs.integers(0, cfg.vocab_size, (1, 48)).astype(np.int32)
    pos = np.arange(48, dtype=np.int32)[None]
    exact = init_cache(cfg, 1, 64, "cpu")
    forward(params, cfg, _t(toks[:, :29]), _t(pos[:, :29]), mode="full",
            cache=exact)
    padded = init_cache(cfg, 1, 64, "cpu")
    forward(params, cfg, _t(toks), _t(pos), mode="full", cache=padded,
            valid_len=_t(np.array([29], np.int32)))
    for key in STATE_KEYS:
        np.testing.assert_allclose(_np(padded[0][key]), _np(exact[0][key]),
                                   atol=1e-5, rtol=1e-5)


def test_forward_verify_matches_jax(model):
    jcfg, cfg, jparams, params = model
    jout0, out0 = _prefill(model, [40, 29], 40, seed=5)
    committed = {k: v.clone() for k, v in out0.cache[0].items()}
    tree = chain_tree(4)
    lens = np.array([40, 29], np.int32)
    rs = np.random.default_rng(6)
    toks = rs.integers(0, cfg.vocab_size, (2, tree.size)).astype(np.int32)
    pos = (lens[:, None] + tree.depth[None]).astype(np.int32)
    tm = tree.ancestor_mask
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(toks),
                             jnp.asarray(pos), mode="verify",
                             cache=jout0.cache, cache_len=jnp.asarray(lens),
                             tree_mask=jnp.asarray(tm))
    out = forward(params, cfg, _t(toks), _t(pos), mode="verify",
                  cache=out0.cache, cache_len=_t(lens), tree_mask=_t(tm))
    assert out.cache[0]["wkv_state"].shape == (2, 2, 5, 4, 64, 64)
    _assert_outputs_match(out, jout)
    for key in STATE_KEYS:      # the committed state is left alone
        assert torch.equal(out0.cache[0][key], committed[key])


def test_kernel_wrapper_on_prefill_only(monkeypatch, model):
    """Prefill runs the K6 wrapper on every layer; verify never."""
    jcfg, cfg, jparams, params = model
    calls = []
    fn = ssm_mod.linear_attn_bshd
    monkeypatch.setattr(ssm_mod, "linear_attn_bshd",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    cache = init_cache(cfg, 1, 32, "cpu")
    forward(params, cfg, torch.randint(0, cfg.vocab_size, (1, 24)),
            torch.arange(24)[None], mode="full", cache=cache)
    assert len(calls) == cfg.n_layers
    forward(params, cfg, torch.randint(0, cfg.vocab_size, (1, 5)),
            torch.arange(24, 29)[None], mode="verify", cache=cache,
            cache_len=torch.tensor([24], dtype=torch.int32))
    assert len(calls) == cfg.n_layers


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_commit_matches_jax(active):
    """The candidate at path_nodes[n_accept] becomes the committed state;
    with ``active``, the other rows keep theirs (JAX's prev restore)."""
    rs = np.random.default_rng(7)
    L, B, T, H, d = 2, 3, 5, 2, 8
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    cand = {"wkv_state": r(L, B, T, H, 4, 4), "shift_tm": r(L, B, T, 1, d),
            "shift_cm": r(L, B, T, 1, d)}
    prev = {"wkv_state": r(L, B, H, 4, 4), "shift_tm": r(L, B, 1, d),
            "shift_cm": r(L, B, 1, d)}
    path = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    n_acc = np.array([2, 4, 0], np.int32)
    lens = np.array([10, 3, 7], np.int32)
    act = None if active is None else np.array(active)
    jc = jax_commit([{k: jnp.asarray(v) for k, v in cand.items()}],
                    jnp.asarray(lens), jnp.asarray(path), jnp.asarray(n_acc),
                    active=None if act is None else jnp.asarray(act),
                    prev=[{k: jnp.asarray(v) for k, v in prev.items()}])
    tprev = [{k: _t(v) for k, v in prev.items()}]
    tc = commit_cache([{k: _t(v) for k, v in cand.items()}], _t(lens),
                      _t(path).long(), _t(n_acc),
                      active=None if act is None else _t(act), prev=tprev)
    assert tc[0] is tprev[0]                       # written in place
    for key in STATE_KEYS:
        np.testing.assert_array_equal(_np(tc[0][key]), np.asarray(jc[0][key]))
    if act is not None:
        np.testing.assert_array_equal(_np(tc[0]["wkv_state"])[:, 1],
                                      prev["wkv_state"][:, 1])


def test_one_node_commit_leaves_attention_alone():
    """The autoregressive step's one-node path moves no attention entry:
    the port leaves the arrays untouched, as JAX's commit returns them."""
    rs = np.random.default_rng(3)
    kv = {n: rs.standard_normal((2, 3, 16, 2, 4), dtype=np.float32)
          for n in ("k", "v")}
    path = np.zeros((3, 1), np.int32)
    lens = np.array([4, 0, 9], np.int32)
    jc = jax_commit([{n: jnp.asarray(a) for n, a in kv.items()}],
                    jnp.asarray(lens), jnp.asarray(path),
                    jnp.zeros(3, jnp.int32))
    group = {n: _t(a) for n, a in kv.items()}
    tc = commit_cache([group], _t(lens), _t(path).long(),
                      torch.zeros(3, dtype=torch.long))
    assert tc[0] is group
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[0][n]), np.asarray(jc[0][n]))
        np.testing.assert_array_equal(_np(tc[0][n]), kv[n])


def test_commit_of_a_state_group_needs_prev():
    cand = [{"wkv_state": torch.zeros(1, 2, 5, 1, 4, 4)}]
    with pytest.raises(ValueError, match="prev"):
        commit_cache(cand, torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, 5, dtype=torch.long),
                     torch.zeros(2, dtype=torch.long))


# ---------------------------------------------------------------------------
# generate and the engines
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
    assert tree.size == 5 and tree.max_depth == 4       # the chain
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
    """JAX serial ``generate()`` per request of a ragged workload; the
    port's serial ``generate()`` must give the same stream for every
    request."""
    jcfg, cfg, jparams, jdp, params, dp = served["hydra++"]
    tree = tree_for(cfg)
    rs = np.random.default_rng(9)
    refs = []
    for n, budget in zip(LENS, BUDGETS):
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


@pytest.mark.parametrize("engine,num_blocks", [("continuous", None),
                                               ("paged", None),
                                               ("paged", 8)])
def test_engines_match_serial_generate(serial, engine, num_blocks):
    """Ragged prompts (bucket-padded prefill, length-masked scan) through
    the continuous engine, the paged one with a dense-equivalent pool,
    and a pool small enough to queue, preempt and re-prefill: every
    request equals JAX serial ``generate()`` exactly."""
    cfg, params, dp, tree, refs = serial
    reqs = [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]
    if engine == "paged":
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                     block_size=BS, num_blocks=num_blocks,
                                     device="cpu")
    else:
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                device="cpu")
    stats = eng.serve(reqs, max_batch=4)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    assert stats.tokens_per_step > 1.0
    if num_blocks is not None:
        assert stats.preemptions >= 1


@pytest.mark.parametrize("engine", ["paged", "continuous"])
def test_serve_launcher_on_the_cpu(capsys, engine):
    serve.main(["--arch", ARCH, "--engine", engine, "--batch", "2",
                "--requests", "3", "--prompt-len", "12", "--ragged",
                "--max-new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] arch={ARCH}-smoke tree=5 (chain=True)" in out
    assert f"[serve] engine={engine} " in out and "tokens=12 " in out
