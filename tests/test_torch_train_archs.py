"""Base-model training of the recurrent and MoE archs, the port against
the JAX package (fp32, CPU, ``reduced()`` forms).

Same params (JAX init, converted through the bridge) and the same numpy
tokens go through both packages; JAX differentiates with
``jax.value_and_grad``, the port with ``trainer.value_and_grad``.  Loss
within relative 1e-5, gradients within relative L2 1e-4, as in
``tests/test_torch_losses.py``:

* ``lm_loss`` and every base leaf's gradient at rwkv6-1.6b (K6 under
  autograd: ``LinearAttnChunk``), zamba2-1.2b (the Mamba2 SSD and the
  shared block's K3), deepseek-v2-lite-16b (MLA, the MoE) and
  deepseek-moe-16b (GQA, the MoE), S = 70, not a multiple of the scan's
  chunk; the MoE archs' ``aux`` metric against JAX's and above zero;
* ``moe_fwd``'s router load-balance loss against JAX's at both MoE archs,
  with the capacity binding (tokens dropped), and the gradient of
  ``sum(out * w) + aux`` with respect to every MoE leaf;
* ``aux_loss`` in the forward's other modes: a zero in verify mode;
* one step of the launcher's ``make_train_step`` against JAX's
  ``repro/launch/specs.py::make_train_step``: every param after the
  update within relative L2 1e-4;
* ``python -m repro_torch.launch.train --arch <a> --device cpu`` trains
  two steps of each arch with finite losses, and raises without a card
  when not asked for the CPU.
"""
import dataclasses
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import (assert_trees_close, cfg_pair,  # noqa: E402
                             to_np, tokens)
from repro.core import distill as jdistill  # noqa: E402
from repro.launch.specs import make_train_step as jax_train_step  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training.optim import init_adamw as jax_init_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import distill  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import (forward, group_program,  # noqa: E402
                                      init_cache)
from repro_torch.training.optim import init_adamw  # noqa: E402
from repro_torch.training.trainer import value_and_grad  # noqa: E402

torch.set_num_threads(2)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
S = 70
ARCHS = ["rwkv6-1.6b", "zamba2-1.2b", "deepseek-v2-lite-16b",
         "deepseek-moe-16b"]
MOE_ARCHS = ARCHS[2:]


def _base(name, seed=0):
    jcfg, cfg = cfg_pair(name)
    jparams = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_jax(to_np(jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _jax_vg(fn, arg):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        fn, has_aux=True))(arg)
    return loss, metrics, grads


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_matches_jax(name):
    jcfg, cfg, jparams, params = _base(name)
    toks = tokens(11, 2, S, cfg.vocab_size)
    jl, jm, jg = _jax_vg(lambda p: jdistill.lm_loss(
        p, jcfg, jnp.asarray(toks), logit_chunk=S), jparams)
    tl, tm, tg = value_and_grad(lambda p: distill.lm_loss(
        p, cfg, torch.from_numpy(toks), logit_chunk=S), params)
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert float(tm["acc"]) == float(jm["acc"])
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=LOSS_REL,
                                             abs=0.0)
    if cfg.moe is not None:
        assert float(tm["aux"]) > 0
    else:
        assert float(tm["aux"]) == 0.0
    assert_trees_close(tg, jg, GRAD_REL, f"{name} grads")


def _moe_layer(name, seed):
    jcfg, cfg = cfg_pair(name)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, bridge._convert(to_np(jp), "cpu")


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["default", "binding"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_aux_and_grads_match_jax(name, cf):
    jcfg, cfg, jp, p = _moe_layer(name, seed=3)
    rs = np.random.default_rng(5)
    x = rs.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    w = rs.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    N, K = 80, cfg.moe.top_k
    C = moe.capacity(N, cfg, cf)
    dropped = N * K > cfg.moe.n_routed * C
    assert dropped == (cf < 1)

    def jfn(params):
        out, aux = jax_moe.moe_fwd(params, jcfg, jnp.asarray(x),
                                   capacity_factor=cf)
        return jnp.sum(out * w) + aux, {"aux": aux}

    def tfn(params):
        out, aux = moe.moe_fwd(params, cfg, torch.from_numpy(x),
                               capacity_factor=cf)
        return (out * torch.from_numpy(w)).sum() + aux, {"aux": aux}

    jl, jm, jg = _jax_vg(jfn, jp)
    tl, tm, tg = value_and_grad(tfn, p)
    assert tm["aux"].dtype == torch.float32 and tm["aux"].dim() == 0
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=LOSS_REL)
    assert float(tm["aux"]) > 0
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert_trees_close(tg, jg, GRAD_REL, f"{name} moe grads")
    # the router's gradient comes through the combine weights and aux
    assert float(tg["router"].abs().sum()) > 0


def test_aux_loss_is_zero_in_verify_mode():
    """The aux is computed only when asked for (``lm_loss`` asks): a
    prefill and a verify step compute none; a dense config asked for it
    gives a zero."""
    _, cfg, _, params = _base("deepseek-moe-16b")
    toks = torch.from_numpy(tokens(2, 2, 20, cfg.vocab_size)).long()
    pos = torch.arange(20).expand(2, 20)
    with torch.no_grad():
        full = forward(params, cfg, toks, pos, want_logits=False,
                       want_aux=True)
        cache = init_cache(cfg, 2, 64, "cpu")
        pre = forward(params, cfg, toks, pos, cache=cache, want_logits=False)
        ver = forward(params, cfg, toks[:, :4], 20 + torch.arange(4).expand(
            2, 4), mode="verify", cache=cache,
            cache_len=torch.full((2,), 20, dtype=torch.int32))
    assert full.aux_loss.dtype == torch.float32 and full.aux_loss.dim() == 0
    assert float(full.aux_loss) > 0
    assert pre.aux_loss is None and ver.aux_loss is None
    _, dcfg, _, dparams = _base("vicuna-tiny")
    with torch.no_grad():
        dense = forward(dparams, dcfg, toks % dcfg.vocab_size, pos,
                        want_logits=False, want_aux=True)
    assert float(dense.aux_loss) == 0.0 and dense.aux_loss.dim() == 0


@pytest.mark.parametrize("name", ARCHS)
def test_make_train_step_matches_jax(name):
    """Two steps (the first at the warm-up's learning rate 0): the
    params and both AdamW moments after each."""
    jcfg, cfg, jparams, params = _base(name, seed=1)
    jstep, step = jax.jit(jax_train_step(jcfg)), launcher.make_train_step(cfg)
    jopt, opt = jax_init_adamw(jparams), init_adamw(params)
    for i in range(2):
        toks = tokens(12 + i, 2, S, cfg.vocab_size)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {"tokens": jnp.asarray(toks)})
        params, opt, m = step(params, opt,
                              {"tokens": torch.from_numpy(toks)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_REL)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GRAD_REL)
        for what, got, want in (("params", params, jparams),
                                ("mu", opt.mu, jopt.mu),
                                ("nu", opt.nu, jopt.nu)):
            assert_trees_close(got, want, GRAD_REL,
                               f"{name} {what} after step {i}")


@pytest.mark.parametrize("name", ARCHS)
def test_train_launcher_trains(name, capsys):
    history = launcher.main(["--arch", name, "--steps", "2", "--batch", "2",
                             "--seq-len", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={name}-smoke devices=1" in out
    assert out.rstrip().endswith("[train] done")
    losses = [float(x) for x in re.findall(
        r"^\[train +\d+\] loss=([-\d.naif]+) \(", out, re.M)]
    assert len(history) == 2 and len(losses) == 2
    assert all(math.isfinite(x) for x in losses)


def test_train_launcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", "rwkv6-1.6b", "--steps", "1"])


def test_deepseek_at_two_layers_keeps_its_moe_layer():
    """5g(iii)'s cut: the dense first layer and one MoE layer."""
    for name in MOE_ARCHS:
        _, cfg = cfg_pair(name, reduced=False)
        cut = dataclasses.replace(cfg, n_layers=2)
        assert cut.moe.n_dense_layers == 1
        assert group_program(cut) == [("attn_stack_dense", 1),
                                      ("attn_stack_moe", 1)]
