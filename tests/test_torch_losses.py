"""The port's training objectives against the JAX package (fp32, CPU).

Same params (JAX init, converted through the bridge) and the same numpy
tokens go through both packages' losses; JAX differentiates with
``jax.value_and_grad`` (its training attention is the jnp
``blocked_attention``), the port with ``trainer.value_and_grad`` (K3's
autograd wrapper, whose CPU form runs the plain version and recomputes
it in the backward).  Loss within relative 1e-5, every trained leaf's
gradient within relative L2 1e-4, accuracies exactly equal:

* ``lm_loss`` at vicuna-tiny's ``reduced()`` form, chunked and unchunked
  (gradients of every base leaf, the embedding's among them);
* ``head_train_loss`` for Medusa, Hydra and Hydra++ under ``data`` and
  ``distill`` (gradients of every draft leaf, the Hydra++ prefix layer's
  among them), and with NEFTune noise (JAX's uniform draw injected);
* ``masked_prediction_loss`` at hubert-xlarge's ``reduced()`` form
  (bidirectional, an untied ``lm_head``);
* a windowed config (gemma3-1b ``reduced()`` with a 16-token window that
  binds at S = 48) and one with a QKV bias (qwen2.5-32b ``reduced()``,
  biases set non-zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import (assert_trees_close, cfg_pair, to_np,  # noqa: E402
                             tokens)
from repro.core import distill as jdistill  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import distill  # noqa: E402
from repro_torch.training.pytree import tree_leaves  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402

torch.set_num_threads(2)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
S = 48
HEADS = {"medusa": dict(kind="medusa", n_heads=3, n_mlp_layers=1,
                        prefix_attention=False),
         "hydra": dict(kind="hydra", n_heads=3, n_mlp_layers=1,
                       prefix_attention=False),
         "hydra++": dict(kind="hydra++", n_heads=3, n_mlp_layers=2,
                         prefix_attention=True)}


def _base(name, seed=0, reduced=True, bias=False, **kw):
    jcfg, cfg = cfg_pair(name, reduced=reduced, **kw)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    if bias:        # JAX inits the QKV biases at zero: make them count
        rs = np.random.default_rng(seed)
        for g in jparams["groups"]:
            for key in ("bq", "bk", "bv"):
                g["attn"][key] = jnp.asarray(
                    0.1 * rs.standard_normal(g["attn"][key].shape),
                    jnp.float32)
    params = bridge.params_from_jax(to_np(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _check(want, got, metrics_equal=()):
    """want/got: (loss, metrics, grads); JAX's first."""
    (jl, jm, jg), (tl, tm, tg) = want, got
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in metrics_equal:
        assert float(tm[k]) == float(jm[k]), (k, float(tm[k]), float(jm[k]))
    return assert_trees_close(tg, jg, GRAD_REL, "grads")


def _jax_vg(fn, arg):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(arg)
    return loss, metrics, grads


@pytest.fixture(scope="module")
def tiny():
    return _base("vicuna-tiny")


@pytest.mark.parametrize("chunk", [16, S])
def test_lm_loss_matches_jax(tiny, chunk):
    jcfg, cfg, jparams, params = tiny
    toks = tokens(1, 2, S, cfg.vocab_size)
    want = _jax_vg(lambda p: jdistill.lm_loss(p, jcfg, jnp.asarray(toks),
                                              logit_chunk=chunk), jparams)
    got = value_and_grad(lambda p: distill.lm_loss(
        p, cfg, torch.from_numpy(toks), logit_chunk=chunk), params)
    _check(want, got, ("acc",))
    assert float(got[1]["nll"]) == pytest.approx(float(want[1]["nll"]),
                                                 rel=LOSS_REL)


@pytest.mark.parametrize("objective", ["data", "distill"])
@pytest.mark.parametrize("kind", sorted(HEADS))
def test_head_train_loss_matches_jax(kind, objective):
    jcfg, cfg, jparams, params = _base("vicuna-tiny",
                                       draft=HEADS[kind])
    jdp = jax_init_draft(jax.random.PRNGKey(5), jcfg)
    dp = bridge.draft_params_from_jax(to_np(jdp), cfg, device="cpu")
    toks = tokens(2, 2, S, cfg.vocab_size)
    want = _jax_vg(lambda d: jdistill.head_train_loss(
        d, jparams, jcfg, jnp.asarray(toks), objective=objective), jdp)
    got = value_and_grad(lambda d: distill.head_train_loss(
        d, params, cfg, torch.from_numpy(toks), objective=objective), dp)
    accs = [f"head{j}_acc" for j in range(cfg.draft.n_heads)]
    losses = [f"head{j}_loss" for j in range(cfg.draft.n_heads)]
    _check(want, got, accs)
    for k in losses:
        assert float(got[1][k]) == pytest.approx(float(want[1][k]),
                                                 rel=LOSS_REL)
    # the base is frozen: no base param requires or holds a gradient
    assert not any(p.requires_grad or p.grad is not None
                   for p in tree_leaves(params))


def test_neftune_noise_matches_jax():
    """NEFTune with JAX's own uniform draw injected into the port."""
    jcfg, cfg, jparams, params = _base("vicuna-tiny",
                                       draft=HEADS["hydra"])
    jdp = jax_init_draft(jax.random.PRNGKey(5), jcfg)
    dp = bridge.draft_params_from_jax(to_np(jdp), cfg, device="cpu")
    toks = tokens(3, 2, S, cfg.vocab_size)
    key = jax.random.PRNGKey(11)
    noise = np.array(jax.random.uniform(key, (2, S, cfg.d_model),
                                          jnp.float32, -1.0, 1.0))
    want = _jax_vg(lambda d: jdistill.head_train_loss(
        d, jparams, jcfg, jnp.asarray(toks), noise_alpha=5.0, rng=key), jdp)
    got = value_and_grad(lambda d: distill.head_train_loss(
        d, params, cfg, torch.from_numpy(toks), noise_alpha=5.0,
        noise=torch.from_numpy(noise)), dp)
    _check(want, got, [f"head{j}_acc" for j in range(3)])
    clean = value_and_grad(lambda d: distill.head_train_loss(
        d, params, cfg, torch.from_numpy(toks)), dp)
    assert float(clean[0]) != float(got[0])        # the noise did count
    # a draw from a generator is uniform on [-1, 1)
    g = torch.Generator().manual_seed(0)
    u = distill.neftune_noise((4096,), g, "cpu")
    assert -1.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.05


def test_masked_prediction_loss_matches_jax():
    jcfg, cfg, jparams, params = _base("hubert-xlarge")
    rs = np.random.default_rng(4)
    B, Sa = 2, 40
    feats = rs.standard_normal((B, Sa, cfg.d_model)).astype(np.float32)
    tgts = rs.integers(0, cfg.vocab_size, (B, Sa)).astype(np.int32)
    mask = rs.random((B, Sa)) < 0.3
    want = _jax_vg(lambda p: jdistill.masked_prediction_loss(
        p, jcfg, jnp.asarray(feats), jnp.asarray(tgts), jnp.asarray(mask)),
        jparams)
    got = value_and_grad(lambda p: distill.masked_prediction_loss(
        p, cfg, torch.from_numpy(feats), torch.from_numpy(tgts),
        torch.from_numpy(mask)), params)
    _check(want, got, ("acc",))
    assert float(np.abs(got[2]["lm_head"].numpy()).sum()) > 0
    assert float(np.abs(got[2]["mask_embed"].numpy()).sum()) > 0


@pytest.mark.parametrize("name,kw", [
    ("gemma3-1b", dict(window_pattern=(16, 0))),
    ("qwen2.5-32b", dict(bias=True))])
def test_windowed_and_biased_configs_match_jax(name, kw):
    bias = kw.pop("bias", False)
    jcfg, cfg, jparams, params = _base(name, bias=bias, **kw)
    toks = tokens(6, 2, S, cfg.vocab_size)
    want = _jax_vg(lambda p: jdistill.lm_loss(p, jcfg, jnp.asarray(toks),
                                              logit_chunk=16), jparams)
    got = value_and_grad(lambda p: distill.lm_loss(
        p, cfg, torch.from_numpy(toks), logit_chunk=16), params)
    _check(want, got, ("acc",))
    # and its Hydra++ heads (the prefix layer at window 0) under distill
    jdp = jax_init_draft(jax.random.PRNGKey(7), jcfg)
    dp = bridge.draft_params_from_jax(to_np(jdp), cfg, device="cpu")
    want = _jax_vg(lambda d: jdistill.head_train_loss(
        d, jparams, jcfg, jnp.asarray(toks), objective="distill"), jdp)
    got = value_and_grad(lambda d: distill.head_train_loss(
        d, params, cfg, torch.from_numpy(toks), objective="distill"), dp)
    _check(want, got)
