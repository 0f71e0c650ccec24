"""Sampled decoding of the port against the JAX reference, at the level of
the criteria and the single draws (fp32, inputs made with numpy).

* ``jax.random.categorical(key, x)`` is ``argmax(x + gumbel(key,
  x.shape))`` on the installed JAX: the port samples Gumbel-max, so JAX's
  noise handed to the port gives JAX's token;
* ``typical_verify``: ``accept_mask``, ``path_nodes`` and ``n_accept``
  equal JAX's exactly on random cases (``default_tree(16, 4, 4)`` and
  ``chain_tree(4)``, τ in {0.5, 0.7, 1.0}, ε in {0.05, 0.15, 0.3}, α
  default and set), with no candidate within 1e-6 of its threshold (so
  rounding across frameworks cannot flip the strict ``>``), and the bonus
  token equal with JAX's Gumbel noise injected; JAX's two threshold cases
  (``tests/test_verify.py``) mirrored;
* ``chain_rejection_verify`` equals JAX's exactly with JAX's uniforms and
  its ``fold_in(rng, 1)`` bonus noise injected; the distribution checks of
  ``tests/test_verify.py`` hold for the port's own draws;
* the sampled autoregressive token and the sampled first token equal
  JAX's with JAX's noise injected;
* the port's own sampler passes a chi-square test against ``softmax`` at
  a fixed seed, and a sampler that ignores the temperature fails it.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.core.speculative import \
    autoregressive_step as jax_ar_step  # noqa: E402
from repro.core.speculative import \
    init_decode_state as jax_init_state  # noqa: E402
from repro.core.trees import chain_tree, default_tree  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import verify  # noqa: E402
from repro_torch.core.speculative import (_first_token,  # noqa: E402
                                          autoregressive_step,
                                          init_decode_state)
from repro_torch.models.model import forward  # noqa: E402

torch.set_num_threads(2)
TREES = {"tree16": default_tree(16, 4, 4), "chain4": chain_tree(4)}
MARGIN = 1e-6          # least |p(candidate) - threshold| a case may have


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", [(7,), (3, 50), (2, 4, 1000)])
def test_jax_categorical_is_gumbel_argmax(shape):
    """The premise of every injected-noise test below."""
    x = jnp.asarray(np.random.default_rng(len(shape)).standard_normal(
        shape).astype(np.float32) * 3)
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        np.testing.assert_array_equal(
            np.asarray(jnp.argmax(x + jax.random.gumbel(key, x.shape), -1)),
            np.asarray(jax.random.categorical(key, x)))


# ---------------------------------------------------------------------------
# typical acceptance
# ---------------------------------------------------------------------------


def _typical_case(tree, seed: int, B: int = 8, V: int = 32):
    """Peaked random logits, and candidates that pick one of their parent's
    three likeliest tokens 80% of the time, the likeliest most often (deep
    accepted paths), or a random one (rejections)."""
    rs = np.random.default_rng(seed)
    T = tree.size
    logits = (rs.standard_normal((B, T, V)) * 2.5).astype(np.float32)
    top = np.argsort(-logits, -1)[..., :3]
    toks = rs.integers(0, V, (B, T))
    for i in range(1, T):
        pick = rs.random(B) < 0.8
        rank = rs.choice(3, B, p=(0.7, 0.2, 0.1))
        choice = top[np.arange(B), tree.parents[i], rank]
        toks[pick, i] = choice[pick]
    return logits, toks.astype(np.int32)


def _margin(tree, logits, toks, **kw) -> float:
    """Least distance of a candidate's tempered probability from its
    parent's threshold (the port's fp32 values)."""
    probs, thresh = verify.typical_thresholds(_t(logits), **kw)
    probs, thresh = probs.numpy(), thresh.numpy()
    B = logits.shape[0]
    return min(abs(probs[b, tree.parents[i], toks[b, i]]
                   - thresh[b, tree.parents[i]])
               for b in range(B) for i in range(1, tree.size))


@pytest.mark.parametrize("alpha", [None, 0.2])
@pytest.mark.parametrize("epsilon", [0.05, 0.15, 0.3])
@pytest.mark.parametrize("temperature", [0.5, 0.7, 1.0])
@pytest.mark.parametrize("tree_name", list(TREES))
def test_typical_verify_matches_jax(tree_name, temperature, epsilon, alpha):
    tree = TREES[tree_name]
    seed = int(temperature * 10) * 100 + int(epsilon * 100) + (alpha is None)
    logits, toks = _typical_case(tree, seed)
    kw = dict(temperature=temperature, epsilon=epsilon, alpha=alpha)
    assert _margin(tree, logits, toks, **kw) > MARGIN
    key = jax.random.PRNGKey(seed)
    jr = jverify.typical_verify(tree, jnp.asarray(toks), jnp.asarray(logits),
                                key, **kw)
    B, _, V = logits.shape
    g = jax.random.gumbel(key, (B, V))
    r = verify.typical_verify(tree, _t(toks).long(), _t(logits), gumbel=_t(g),
                              **kw)
    for name in ("accept_mask", "path_nodes", "n_accept", "bonus_token"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    n = r.n_accept.numpy()
    assert n.max() >= 2 and not r.accept_mask.numpy().all()


def test_typical_thresholds_as_jax():
    """tests/test_verify.py::test_typical_thresholds on the port: a
    near-deterministic base accepts its token and rejects another."""
    tree = chain_tree(2)
    logits = np.full((1, 3, 8), -10.0, np.float32)
    logits[:, :, 3] = 10.0
    gen = torch.Generator().manual_seed(0)
    for toks, want in (([[0, 3, 3]], 2), ([[0, 4, 3]], 0)):
        toks = np.array(toks, np.int32)
        r = verify.typical_verify(tree, _t(toks).long(), _t(logits), gen,
                                  temperature=1.0, epsilon=0.1)
        jr = jverify.typical_verify(tree, jnp.asarray(toks),
                                    jnp.asarray(logits),
                                    jax.random.PRNGKey(0), temperature=1.0,
                                    epsilon=0.1)
        assert int(r.n_accept[0]) == int(jr.n_accept[0]) == want


def test_typical_entropy_gate_as_jax():
    """tests/test_verify.py::test_typical_entropy_gate on the port: a
    uniform base of 4 accepts p = 0.25 over min(0.9, 0.9 * exp(-ln 4))."""
    tree = chain_tree(1)
    logits = np.zeros((1, 2, 4), np.float32)
    toks = np.array([[0, 2]], np.int32)
    r = verify.typical_verify(tree, _t(toks).long(), _t(logits),
                              torch.Generator().manual_seed(1),
                              temperature=1.0, epsilon=0.9, alpha=0.9)
    jr = jverify.typical_verify(tree, jnp.asarray(toks), jnp.asarray(logits),
                                jax.random.PRNGKey(1), temperature=1.0,
                                epsilon=0.9, alpha=0.9)
    assert int(r.n_accept[0]) == int(jr.n_accept[0]) == 1


def test_typical_bonus_draws_from_the_generator():
    """Without injected noise the bonus comes from the generator: the same
    seed repeats it, and it lies in the vocabulary."""
    tree = TREES["tree16"]
    logits, toks = _typical_case(tree, 5)
    runs = [verify.typical_verify(tree, _t(toks).long(), _t(logits),
                                  torch.Generator().manual_seed(s)).bonus_token
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < logits.shape[-1]


# ---------------------------------------------------------------------------
# chain rejection resampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_rejection_matches_jax_with_injected_noise(seed, temperature):
    B, K, V = 16, 4, 24
    rs = np.random.default_rng(seed)
    logits = (rs.standard_normal((B, K + 1, V)) * 2).astype(np.float32)
    toks = rs.integers(0, V, (B, K + 1)).astype(np.int32)
    top = logits.argmax(-1)
    for i in range(1, K + 1):          # mostly likely tokens: long chains
        hit = rs.random(B) < 0.8
        toks[hit, i] = top[hit, i - 1]
    dlp = np.log(rs.uniform(0.05, 0.9, (B, K + 1))).astype(np.float32)
    key = jax.random.PRNGKey(50 + seed)
    jr = jverify.chain_rejection_verify(jnp.asarray(toks), jnp.asarray(dlp),
                                        jnp.asarray(logits), key,
                                        temperature=temperature)
    u = jax.random.uniform(key, (B, K))
    g = jax.random.gumbel(jax.random.fold_in(key, 1), (B, V))
    r = verify.chain_rejection_verify(_t(toks).long(), _t(dlp), _t(logits),
                                      temperature=temperature, u=_t(u),
                                      gumbel=_t(g))
    for name in ("accept_mask", "path_nodes", "n_accept", "bonus_token"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    n = r.n_accept.numpy()
    assert 0 < n.mean() < K


def test_chain_rejection_acceptance_as_jax():
    """tests/test_verify.py::test_chain_rejection_distribution_preserving on
    the port's own draws: draft == base accepts every candidate; a draft
    sure of the base's least likely tokens is rejected."""
    B, K, V = 64, 3, 16
    rs = np.random.RandomState(0)
    logits = torch.from_numpy(rs.randn(B, K + 1, V).astype(np.float32))
    logp = torch.log_softmax(logits, -1)
    am, low = logits.argmax(-1), logits.argmin(-1)
    toks = torch.zeros((B, K + 1), dtype=torch.long)
    bad = torch.zeros_like(toks)
    dlp = torch.zeros((B, K + 1))
    for i in range(1, K + 1):
        toks[:, i] = am[:, i - 1]
        bad[:, i] = low[:, i - 1]
        dlp[:, i] = logp[torch.arange(B), i - 1, am[:, i - 1]]
    gen = torch.Generator().manual_seed(0)
    r = verify.chain_rejection_verify(toks, dlp, logits, gen)
    assert float(r.n_accept.float().mean()) == K
    r2 = verify.chain_rejection_verify(bad, torch.zeros((B, K + 1)), logits,
                                       gen)
    assert float(r2.n_accept.float().mean()) < 0.5


# ---------------------------------------------------------------------------
# the sampled autoregressive token and the sampled first token
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """minitron-4b.reduced() in fp32 with a 64-token vocabulary."""
    cfgs = [dataclasses.replace(get("minitron-4b").reduced(),
                                dtype="float32", vocab_size=64)
            for get in (jax_get_config, get_config)]
    jparams = jax_init_params(jax.random.PRNGKey(0), cfgs[0])
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfgs[1], "cpu")
    prompt = np.random.default_rng(7).integers(0, 64, (3, 11)).astype(
        np.int32)
    return cfgs, jparams, params, prompt


@pytest.mark.parametrize("temperature", [0.5, 0.7, 1.3])
def test_sampled_ar_token_matches_jax_with_injected_noise(tiny, temperature):
    (jcfg, cfg), jparams, params, prompt = tiny
    jstate = jax_init_state(jparams, None, jcfg, jnp.asarray(prompt), 64,
                            jax.random.PRNGKey(3))
    jres = jax_ar_step(jparams, jcfg, jstate, greedy=False,
                       temperature=temperature)
    sub = jax.random.split(jstate.rng)[1]      # the step's own split
    g = jax.random.gumbel(sub, (prompt.shape[0], cfg.vocab_size))
    state = init_decode_state(params, None, cfg, _t(prompt).long(), 64)
    res = autoregressive_step(params, cfg, state, greedy=False,
                              temperature=temperature, gumbel=_t(g))
    np.testing.assert_array_equal(res.emitted.numpy(),
                                  np.asarray(jres.emitted))
    greedy = autoregressive_step(
        params, cfg, init_decode_state(params, None, cfg, _t(prompt).long(),
                                       64))
    # the noise matters: some row leaves the argmax
    assert not torch.equal(greedy.emitted, res.emitted) or temperature < 1


def test_sampled_first_token_matches_jax_with_injected_noise(tiny):
    """JAX draws the first token at temperature 1 from ``split(rng)[1]``."""
    (jcfg, cfg), jparams, params, prompt = tiny
    key = jax.random.PRNGKey(11)
    jstate = jax_init_state(jparams, None, jcfg, jnp.asarray(prompt), 64, key,
                            greedy=False)
    g = jax.random.gumbel(jax.random.split(key)[1],
                          (prompt.shape[0], cfg.vocab_size))
    P = prompt.shape[1]
    pos = torch.arange(P).expand(prompt.shape[0], P)
    out = forward(params, cfg, _t(prompt).long(), pos, mode="full",
                  want_logits=False)
    tok0 = _first_token(params, out.hidden[:, -1], greedy=False,
                        gumbel=_t(g))
    np.testing.assert_array_equal(tok0.numpy(),
                                  np.asarray(jstate.last_token))
    assert not torch.equal(tok0, _first_token(params, out.hidden[:, -1]))


# ---------------------------------------------------------------------------
# the port's own sampler
# ---------------------------------------------------------------------------

P_VALUE_FLOOR = 1e-4


def _chi_square_p(draws: np.ndarray, probs: np.ndarray) -> float:
    """p-value of the draws' counts against ``probs`` over the bins with
    p > 1e-3 (the rest lumped into one bin)."""
    V = probs.shape[0]
    counts = np.bincount(draws, minlength=V).astype(np.float64)
    big = probs > 1e-3
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(probs[big], probs[~big].sum()) * draws.size
    keep = exp > 0
    stat = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
    return float(stats.chi2.sf(stat, keep.sum() - 1))


def test_port_sampler_passes_chi_square():
    V, N, temperature = 64, 1 << 17, 0.7
    rs = np.random.default_rng(21)
    logits = torch.from_numpy((rs.standard_normal(V) * 1.5).astype(
        np.float32))
    probs = torch.softmax(logits.double() / temperature, -1).numpy()
    gen = torch.Generator().manual_seed(1234)
    draws, flat = [], []
    for _ in range(N // 4096):
        rows = (logits / temperature).expand(4096, V)
        draws.append(verify.sample_categorical(rows, gen).numpy())
        flat.append(verify.sample_categorical(logits.expand(4096, V),
                                              gen).numpy())
    p = _chi_square_p(np.concatenate(draws), probs)
    assert p > P_VALUE_FLOOR, f"chi-square p-value {p}"
    # a sampler that ignores the temperature fails the same test
    p_flat = _chi_square_p(np.concatenate(flat), probs)
    assert p_flat < P_VALUE_FLOOR, f"temperature ignored, p-value {p_flat}"


def test_gumbel_noise_is_finite_at_the_ends():
    """u = 0 is clamped to the smallest normal float, as JAX's uniform
    starts at it: the noise stays finite."""
    g = verify.gumbel_noise((1 << 16,), torch.Generator().manual_seed(0),
                            "cpu")
    assert torch.isfinite(g).all()
    tiny = torch.tensor([0.0, torch.finfo(torch.float32).tiny])
    assert math.isfinite(float(-torch.log(-torch.log(
        tiny.clamp_min(torch.finfo(torch.float32).tiny)))[0]))
