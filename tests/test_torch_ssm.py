"""The port's RWKV6 layers and decay-attention scans against the JAX
reference (``repro/models/ssm.py``, ``repro/models/layers.py``).

Inputs are made from a numpy seed and handed to both sides; JAX params
are JAX-initialised and converted leaf by leaf.  Everything is fp32 and
held at ``atol = rtol = 1e-4`` (the two sides sum in different orders,
and exponentials of cumulative decays amplify the difference a little):

* ``decay_attention_chunked`` (K6's plain version), with and without an
  initial state and a u bonus, S not a chunk multiple: output and final
  state;
* ``decay_attention_seq``: output and every per-token state;
* within the port: chunked == seq, a split scan carrying its state ==
  the whole scan, and a length-masked pad tail (k = 0, w = 0) leaves the
  real positions' outputs and the final state bitwise unchanged;
* ``rwkv6_timemix`` in full mode (with and without ``valid_len``) and in
  verify mode, ``rwkv6_chanmix`` and ``group_norm``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.linear_attn_chunk.ref import (  # noqa: E402
    decay_attention_chunked)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import group_norm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _scan_inputs(seed, B=2, S=50, H=3, dk=16, dv=16, strong=False):
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    w = -np.exp(r(B, S, H, dk) * (1.5 if strong else 0.5)
                + (1.0 if strong else 0.0))
    return dict(r=r(B, S, H, dk), k=r(B, S, H, dk), v=r(B, S, H, dv),
                w=w.astype(np.float32), u=r(H, dk) * 0.1,
                s0=r(B, H, dk, dv) * 0.1)


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_u", [True, False])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("strong", [False, True])
def test_chunked_matches_jax(use_u, init, strong):
    c = _scan_inputs(1, strong=strong)
    t, j = _t(c), _j(c)
    o, st = decay_attention_chunked(
        t["r"], t["k"], t["v"], t["w"], t["u"] if use_u else None,
        t["s0"] if init else None, chunk=16)
    jo, jst = jax_ssm.decay_attention_chunked(
        j["r"], j["k"], j["v"], j["w"], j["u"] if use_u else None,
        j["s0"] if init else None, chunk=16)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("init", [True, False])
def test_seq_matches_jax(init):
    c = _scan_inputs(2, S=7)
    t, j = _t(c), _j(c)
    o, states = ssm.decay_attention_seq(t["r"], t["k"], t["v"], t["w"],
                                        t["u"], t["s0"] if init else None)
    jo, jstates = jax_ssm.decay_attention_seq(
        j["r"], j["k"], j["v"], j["w"], j["u"], j["s0"] if init else None)
    assert states.shape == (2, 7, 3, 16, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), **TOL)


def test_chunked_equals_seq_in_the_port():
    t = _t(_scan_inputs(3, S=40))
    o, st = decay_attention_chunked(t["r"], t["k"], t["v"], t["w"], t["u"],
                                    t["s0"], chunk=16)
    so, states = ssm.decay_attention_seq(t["r"], t["k"], t["v"], t["w"],
                                         t["u"], t["s0"])
    np.testing.assert_allclose(o.numpy(), so.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), states[:, -1].numpy(), **TOL)


def test_split_scan_carrying_state_equals_whole():
    t = _t(_scan_inputs(4, S=64))
    whole, st = decay_attention_chunked(t["r"], t["k"], t["v"], t["w"],
                                        t["u"], t["s0"], chunk=16)
    cut = lambda x, a, b: x[:, a:b]
    o1, s1 = decay_attention_chunked(
        *(cut(t[n], 0, 32) for n in "rkvw"), t["u"], t["s0"], chunk=16)
    o2, s2 = decay_attention_chunked(
        *(cut(t[n], 32, 64) for n in "rkvw"), t["u"], s1, chunk=16)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(),
                               whole.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), st.numpy(), **TOL)


@pytest.mark.parametrize("real,padded", [(37, 48), (37, 80), (16, 32)])
def test_masked_pad_tail_is_exact(real, padded):
    """k = 0 and w = 0 past the real length (``_mask_decay_inputs``): the
    state passes the pads unchanged, bit for bit."""
    t = _t(_scan_inputs(5, B=1, S=padded))
    o, st = decay_attention_chunked(*(t[n][:, :real] for n in "rkvw"),
                                    t["u"], t["s0"], chunk=16)
    mask = ssm._pad_mask(torch.tensor([real]), padded)
    w_m, k_m = ssm._mask_decay_inputs(mask, t["w"], t["k"])
    o_m, st_m = decay_attention_chunked(t["r"], k_m, t["v"], w_m, t["u"],
                                        t["s0"], chunk=16)
    assert torch.equal(o_m[:, :real], o)
    assert torch.equal(st_m, st)


def test_gather_last_valid_and_pad_mask_match_jax():
    rs = np.random.default_rng(6)
    x = rs.standard_normal((3, 9, 1, 5), dtype=np.float32)
    vl = np.array([9, 1, 4], np.int32)
    np.testing.assert_array_equal(
        ssm._gather_last_valid(torch.from_numpy(x),
                               torch.from_numpy(vl)).numpy(),
        np.asarray(jax_ssm._gather_last_valid(jnp.asarray(x),
                                              jnp.asarray(vl))))
    np.testing.assert_array_equal(
        ssm._pad_mask(torch.from_numpy(vl), 9).numpy(),
        np.asarray(jax_ssm._pad_mask(jnp.asarray(vl), 3, 9)))


# ---------------------------------------------------------------------------
# the RWKV6 layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, port cfg, jax layer params, port layer params): a reduced
    rwkv6-1.6b (d 256, 4 wkv heads of 64, chunk 16) in fp32, with the
    bonus, the decay base and the mus made non-trivial."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6-1.6b").reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              dtype="float32")
    jp = jax_ssm.init_rwkv6(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rs = np.random.default_rng(7)
    for name in ("tm_mu_x", "tm_mu", "u_bonus", "cm_mu_k", "cm_mu_r"):
        jp[name] = jnp.asarray(rs.uniform(-0.5, 0.5, jp[name].shape),
                               jnp.float32)
    jp["w0"] = jnp.asarray(rs.uniform(-3, 0, jp["w0"].shape), jnp.float32)
    p = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(seed, B, T, d):
    return np.random.default_rng(seed).standard_normal((B, T, d),
                                                       dtype=np.float32)


@pytest.mark.parametrize("ragged", [False, True])
def test_timemix_full_matches_jax(layer, ragged):
    jcfg, cfg, jp, p = layer
    B, T, d, H = 2, 37, cfg.d_model, cfg.n_heads
    x = _x(8, B, T, d)
    rs = np.random.default_rng(9)
    s0 = rs.standard_normal((B, H, 64, 64), dtype=np.float32) * 0.1
    sh = rs.standard_normal((B, 1, d), dtype=np.float32)
    vl = np.array([37, 20], np.int32) if ragged else None
    out, new = ssm.rwkv6_timemix(
        p, cfg, torch.from_numpy(x), mode="full",
        wkv_state=torch.from_numpy(s0), shift_last=torch.from_numpy(sh),
        chunk=16, valid_len=None if vl is None else torch.from_numpy(vl))
    jout, jnew = jax_ssm.rwkv6_timemix(
        jp, jcfg, jnp.asarray(x), mode="full", wkv_state=jnp.asarray(s0),
        shift_last=jnp.asarray(sh), chunk=16,
        valid_len=None if vl is None else jnp.asarray(vl))
    rows = slice(None) if vl is None else 0
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jout)[rows],
                               **TOL)
    if vl is not None:       # the shorter row's real positions
        np.testing.assert_allclose(out.numpy()[1, :20],
                                   np.asarray(jout)[1, :20], **TOL)
    for key in ("wkv_state", "shift_tm"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]),
                                   **TOL)


def test_timemix_verify_matches_jax(layer):
    jcfg, cfg, jp, p = layer
    B, T, d, H = 2, 5, cfg.d_model, cfg.n_heads
    x = _x(10, B, T, d)
    rs = np.random.default_rng(11)
    s0 = rs.standard_normal((B, H, 64, 64), dtype=np.float32) * 0.1
    sh = rs.standard_normal((B, 1, d), dtype=np.float32)
    out, new = ssm.rwkv6_timemix(p, cfg, torch.from_numpy(x), mode="verify",
                                 wkv_state=torch.from_numpy(s0),
                                 shift_last=torch.from_numpy(sh))
    jout, jnew = jax_ssm.rwkv6_timemix(jp, jcfg, jnp.asarray(x),
                                       mode="verify",
                                       wkv_state=jnp.asarray(s0),
                                       shift_last=jnp.asarray(sh))
    assert new["wkv_state"].shape == (B, T, H, 64, 64)
    assert new["shift_tm"].shape == (B, T, 1, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for key in ("wkv_state", "shift_tm"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]),
                                   **TOL)


@pytest.mark.parametrize("with_shift", [True, False])
def test_chanmix_matches_jax(layer, with_shift):
    _, cfg, jp, p = layer
    x = _x(12, 2, 9, cfg.d_model)
    sh = _x(13, 2, 1, cfg.d_model) if with_shift else None
    out = ssm.rwkv6_chanmix(p, torch.from_numpy(x),
                            shift_last=None if sh is None
                            else torch.from_numpy(sh))
    jout = jax_ssm.rwkv6_chanmix(jp, jnp.asarray(x),
                                 shift_last=None if sh is None
                                 else jnp.asarray(sh))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_group_norm_matches_jax():
    rs = np.random.default_rng(14)
    x = rs.standard_normal((2, 5, 256), dtype=np.float32) * 3 + 1
    g = rs.standard_normal(256).astype(np.float32)
    b = rs.standard_normal(256).astype(np.float32)
    out = group_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), 4, eps=ssm.GN_EPS)
    jout = jax_layers.group_norm(jnp.asarray(x), jnp.asarray(g),
                                 jnp.asarray(b), 4, eps=64e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
