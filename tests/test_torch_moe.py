"""The port's fine-grained MoE FFN against the JAX reference.

``repro_torch.models.moe.moe_fwd`` against ``repro.models.moe.moe_fwd`` on
a reduced deepseek-v2-lite-16b (4 routed experts, top-2, 1 shared), with
params initialised in JAX and inputs drawn from a numpy seed:

* fp32, ``atol = rtol = 1e-5`` (the two sides sum in different orders),
  at the default capacity factor and at one small enough that tokens are
  dropped (the dropped tokens must be the same on both sides, or the
  outputs differ by whole expert outputs);
* the capacity is invariant to right-padding up to the next multiple of
  ``CAPACITY_ROUND`` (the fix of the MLA bucketed-prefill divergence):
  a token's output is the same prefilled exact-length or padded;
* the router stays fp32 in a bf16 model, through the bridge too; bf16
  against JAX within ``atol = rtol = 2e-2``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(dtype="float32"):
    return [dataclasses.replace(get("deepseek-v2-lite-16b").reduced(),
                                dtype=dtype)
            for get in (jax_get_config, get_config)]


def _params(jcfg, seed=0):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg,
                          jnp.dtype(jcfg.dtype))
    tp = bridge._convert(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jp, tp


def _x(B, T, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, T, d), dtype=np.float32)


def _dropped(cfg, p, x, capacity_factor):
    """How many (token, choice) pairs overflow their expert (port side)."""
    N = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x).reshape(N, -1)
                          @ p["router"], -1)
    top_e = torch.topk(probs, cfg.moe.top_k, -1).indices.reshape(-1)
    counts = torch.bincount(top_e, minlength=cfg.moe.n_routed)
    C = moe.capacity(N, cfg, capacity_factor)
    return int(torch.clamp_min(counts - C, 0).sum())


def test_capacity_round_is_jax_s():
    assert moe.CAPACITY_ROUND == jax_moe.CAPACITY_ROUND == 64


@pytest.mark.parametrize("B,T,cf", [(2, 8, 1.25), (1, 40, 1.25),
                                    (4, 16, 0.25)],
                         ids=["verify", "prefill", "forced-overflow"])
def test_moe_fwd_matches_jax(B, T, cf):
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg)
    x = _x(B, T, cfg.d_model, seed=B * T)
    jout, _ = jax_moe.moe_fwd(jp, jcfg, jnp.asarray(x), capacity_factor=cf)
    out, _ = moe.moe_fwd(p, cfg, torch.from_numpy(x),
                         capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    if cf < 1:
        assert _dropped(cfg, p, x, cf) > 0, "no token was dropped"


@pytest.mark.parametrize("n", [5, 23, 40, 64])
def test_right_pad_keeps_every_real_token(n):
    """n real tokens, alone and right-padded to 64: the same capacity, and
    the real tokens' outputs agree with each other and with JAX."""
    jcfg, cfg = _cfgs()
    jp, p = _params(jcfg, seed=1)
    x = _x(1, 64, cfg.d_model, seed=n)
    x[:, n:] = _x(1, 64 - n, cfg.d_model, seed=100 + n)  # pad-slot junk
    assert moe.capacity(n, cfg) == moe.capacity(64, cfg)
    exact = moe.moe_fwd(p, cfg, torch.from_numpy(x[:, :n]))[0].numpy()
    padded = moe.moe_fwd(p, cfg, torch.from_numpy(x))[0].numpy()[:, :n]
    np.testing.assert_allclose(padded, exact, atol=1e-6, rtol=1e-6)
    jpadded, _ = jax_moe.moe_fwd(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(padded, np.asarray(jpadded)[:, :n], **TOL)


def test_router_stays_fp32_in_a_bf16_model():
    """JAX keeps the router in fp32 inside a bf16 model; the bridge keeps
    it so (and the experts bf16), and the bf16 forward agrees with JAX."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    mp = params["groups"][1]["moe"]
    assert mp["router"].dtype == torch.float32
    assert {mp[k].dtype for k in ("w_gate", "w_up", "w_down")} == {
        torch.bfloat16}
    assert params["embed"].dtype == torch.bfloat16
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"][1]["moe"])
    x = _x(2, 8, cfg.d_model, seed=3)
    jout, _ = jax_moe.moe_fwd(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    lp = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in mp.items()}
    out, _ = moe.moe_fwd(lp, cfg, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
