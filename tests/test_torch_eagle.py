"""EAGLE in the port against the JAX package (vicuna-tiny, fp32, CPU),
with JAX's params converted through ``bridge.eagle_params_from_jax``.

* ``eagle_train_loss``: loss within relative 1e-5, every EAGLE leaf's
  gradient within relative L2 1e-4 of ``jax.value_and_grad``'s, accuracy
  exactly equal;
* ``eagle_draft_chain`` from the same prefilled state: the chain's tokens
  exactly equal (log-probs within 1e-4);
* 14 greedy ``eagle_spec_step``s from ``init_eagle_decode_state`` on two
  prompts of 16: streams exactly equal to JAX's, and equal to the port's
  autoregressive ``generate`` (JAX's
  ``test_eagle_greedy_equals_autoregressive``);
* the in-place caches: a step leaves every committed draft-cache entry
  below ``cache_len`` unchanged, and the entries it commits are the
  rebuild's (a fresh rebuild from the same hiddens gives their bits);
* the typical criterion with JAX's Gumbel noise injected: streams equal;
* at an 8-token vocabulary, where random drafts get accepted and a step
  commits several rebuilt entries, the greedy stream still equals the
  autoregressive one and the caches keep their committed entries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import (assert_trees_close, cfg_pair, to_np,  # noqa: E402
                             tokens)
from repro.core import eagle as jeagle  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.core.trees import chain_tree  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402

torch.set_num_threads(2)
K = 4
MAX_LEN = 256
STEPS = 14


@pytest.fixture(scope="module")
def setup():
    rng = jax.random.PRNGKey(3)
    jcfg, cfg = cfg_pair("vicuna-tiny", reduced=False)
    jparams = jax_init_params(rng, jcfg)
    jep = jeagle.init_eagle_params(jax.random.fold_in(rng, 1), jcfg)
    params = bridge.params_from_jax(to_np(jparams), cfg, device="cpu")
    ep = bridge.eagle_params_from_jax(to_np(jep), cfg, device="cpu")
    prompt = np.array(jax.random.randint(rng, (2, 16), 0, cfg.vocab_size))
    jstep = jax.jit(lambda p, d, st: jeagle.eagle_spec_step(p, d, jcfg, K,
                                                            st))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jep=jep, params=params,
                ep=ep, prompt=prompt, rng=rng, jstep=jstep)


def _emitted(em, ne):
    em, ne = np.asarray(em), np.asarray(ne)
    return np.where(np.arange(em.shape[1])[None] < ne[:, None], em, -1)


def _depad(row):
    return [int(t) for t in row if t != PAD_TOKEN]


def test_eagle_train_loss_matches_jax(setup):
    s = setup
    toks = tokens(5, 2, 48, s["cfg"].vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda e: jeagle.eagle_train_loss(e, s["jparams"], s["jcfg"],
                                          jnp.asarray(toks)),
        has_aux=True))(s["jep"])
    tl, tm, tg = value_and_grad(lambda e: eagle.eagle_train_loss(
        e, s["params"], s["cfg"], torch.from_numpy(toks)), s["ep"])
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k in ("ce", "hidden_l1"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    assert_trees_close(tg, jg, 1e-4, "EAGLE grads")


def _states(s):
    jst = jeagle.init_eagle_decode_state(s["jparams"], s["jep"], s["jcfg"],
                                         jnp.asarray(s["prompt"]), MAX_LEN,
                                         s["rng"])
    st = eagle.init_eagle_decode_state(s["params"], s["ep"], s["cfg"],
                                       torch.from_numpy(s["prompt"]), MAX_LEN)
    assert np.array_equal(st.last_token.numpy(), np.asarray(jst.last_token))
    return jst, st


def test_eagle_draft_chain_matches_jax(setup):
    s = setup
    jst, st = _states(s)
    jd = jax.jit(lambda e, p, st: jeagle.eagle_draft_chain(
        e, s["jcfg"], p, K, st.last_hidden, st.last_token, st.prefix_k,
        st.prefix_v, st.cache_len))(s["jep"], s["jparams"], jst)
    d = eagle.eagle_draft_chain(s["ep"], s["cfg"], s["params"], K,
                                st.last_hidden, st.last_token, st.prefix_k,
                                st.prefix_v, st.cache_len)
    assert np.array_equal(d.tokens.numpy(), np.asarray(jd.tokens))
    np.testing.assert_allclose(d.logp.numpy(), np.asarray(jd.logp),
                               atol=1e-4, rtol=1e-4)


def _port_greedy(s, st, steps=STEPS, check_cache=False):
    outs = [st.last_token.numpy()[:, None]]
    for _ in range(steps):
        before_k = st.prefix_k.clone()
        before_len = st.cache_len.clone()
        res = eagle.eagle_spec_step(s["params"], s["ep"], s["cfg"], K, st)
        if check_cache:
            _check_caches(s, st, res, before_k, before_len)
        st = res.state
        outs.append(_emitted(res.emitted, res.n_emitted))
    return np.concatenate(outs, 1)


def _check_caches(s, st, res, before_k, before_len):
    """Entries below the step's cache_len unchanged; the entries it
    commits [cache_len, new cache_len) hold the rebuild's bits."""
    new_k = res.state.prefix_k
    for b in range(new_k.shape[0]):
        n0, n1 = int(before_len[b]), int(res.state.cache_len[b])
        assert torch.equal(new_k[b, :n0], before_k[b, :n0])
        assert n1 > n0
    # the rebuild from the same inputs on a copy gives the committed bits
    # (here: the first committed entry, keyed by the last token and hidden)
    E = s["params"]["embed"]
    z = torch.cat([E[st.last_token], st.last_hidden.to(E.dtype)],
                  -1) @ s["ep"]["fc"]
    ck, cv = before_k.clone(), st.prefix_v.clone()
    eagle._eagle_layer(s["ep"], s["cfg"], z[:, None], st.cache_len[:, None],
                       ck, cv, st.cache_len)
    for b in range(new_k.shape[0]):
        n0 = int(before_len[b])
        assert torch.equal(new_k[b, n0], ck[b, n0])


def test_eagle_greedy_steps_match_jax(setup):
    s = setup
    jst, st = _states(s)
    outs = [np.asarray(jst.last_token)[:, None]]
    for _ in range(STEPS):
        res = s["jstep"](s["jparams"], s["jep"], jst)
        jst = res.state
        outs.append(_emitted(res.emitted, res.n_emitted))
    want = np.concatenate(outs, 1)
    got = _port_greedy(s, st, check_cache=True)
    for b in range(2):
        assert _depad(got[b]) == _depad(want[b]), f"row {b}"


def test_eagle_greedy_equals_autoregressive(setup):
    s = setup
    _, st = _states(s)
    got = _port_greedy(s, st)
    with torch.no_grad():
        ar, _, _ = generate(s["params"], None, s["cfg"], chain_tree(K),
                            torch.from_numpy(s["prompt"]).long(),
                            max_new_tokens=STEPS, max_len=MAX_LEN,
                            use_speculative=False)
    for b in range(2):
        g, a = _depad(got[b])[:12], _depad(ar[b].numpy())[:12]
        assert g == a, f"row {b}: {g} != {a}"
    # and JAX's autoregressive stream is the same
    jar, _, _ = jax_generate(s["jparams"], None, s["jcfg"], chain_tree(K),
                             jnp.asarray(s["prompt"]), max_new_tokens=STEPS,
                             max_len=MAX_LEN, use_speculative=False)
    for b in range(2):
        assert _depad(np.asarray(jar[b]))[:12] == _depad(ar[b].numpy())[:12]


def test_eagle_typical_matches_jax_with_its_noise(setup):
    s = setup
    jst, st = _states(s)
    jstep = jax.jit(lambda p, d, x: jeagle.eagle_spec_step(
        p, d, s["jcfg"], K, x, criterion="typical"))
    V = s["cfg"].vocab_size
    for i in range(6):
        sub = jax.random.split(jst.rng)[1]
        g = np.array(jax.random.gumbel(sub, (2, V)))
        jres = jstep(s["jparams"], s["jep"], jst)
        res = eagle.eagle_spec_step(s["params"], s["ep"], s["cfg"], K, st,
                                    criterion="typical",
                                    gumbel=torch.from_numpy(g))
        assert np.array_equal(_emitted(res.emitted, res.n_emitted),
                              _emitted(jres.emitted, jres.n_emitted)), i
        jst, st = jres.state, res.state


def test_eagle_accepting_drafts_equals_autoregressive():
    """At an 8-token vocabulary random EAGLE drafts get accepted, so steps
    commit several rebuilt entries: the greedy stream still equals the
    autoregressive one, and every step keeps the committed entries."""
    from repro_torch.models.model import init_params
    _, cfg = cfg_pair("vicuna-tiny", reduced=False, vocab_size=8)
    params = init_params(cfg, seed=2, device="cpu")
    ep = eagle.init_eagle_params(cfg, seed=3, device="cpu")
    s = dict(params=params, ep=ep, cfg=cfg)
    prompt = torch.from_numpy(tokens(8, 2, 16, 8)).long()
    st = eagle.init_eagle_decode_state(params, ep, cfg, prompt, MAX_LEN)
    got = _port_greedy(s, st, steps=10, check_cache=True)
    n = sum(len(_depad(r)) for r in got) - 2
    assert n >= 2 * 10 + 4, "too few drafts accepted: the case tests little"
    with torch.no_grad():
        ar, _, _ = generate(params, None, cfg, chain_tree(K), prompt,
                            max_new_tokens=40, max_len=MAX_LEN,
                            use_speculative=False)
    for b in range(2):
        g = _depad(got[b])
        assert g == _depad(ar[b].numpy())[:len(g)], f"row {b}"
