"""The port's Mamba2 layer (``repro_torch/models/ssm.py``) against the JAX
reference (``repro/models/ssm.py``), at ``zamba2-1.2b.reduced()`` (d 256,
d_in 512, 8 SSD heads of 64, d_state 16, chunk 16) in fp32.

Inputs are made from a numpy seed and handed to both sides; JAX params
are JAX-initialised (with a non-trivial decay rate, step bias, skip, conv
bias and gate norm) and converted leaf by leaf.  Tensors are held at
``atol = rtol = 1e-4``:

* ``_causal_conv`` with and without a carried window: the output and the
  window after every token;
* ``mamba2_ssd_chunked`` (the grouped SSD: B and C shared across heads,
  one decay per head and token, the inclusive mask) at S in {11, 16, 37},
  with and without an initial state, under mild and strong decays: the
  output and the final state;
* ``decay_attention_seq`` with the post-update readout and a (B, T, H, 1)
  scalar decay, B and C broadcast as views: the output and every state;
  within the port it equals the grouped SSD;
* ``mamba2_fwd`` in full mode (with ``valid_len`` on a right-padded input
  and without, from zero and from carried states) and in verify mode; a
  padded prefill's states equal the exact-length prefill's within the
  tolerance (not bitwise: JAX itself differs there on this tree); and a
  full prefix followed by a verify over the suffix equals one full pass
  (in the port and against JAX).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "zamba2-1.2b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.fixture(scope="module")
def layer():
    """(jax cfg, port cfg, jax layer params, port layer params)."""
    jcfg, cfg = (dataclasses.replace(get(ARCH).reduced(), dtype="float32")
                 for get in (jax_get_config, get_config))
    jp = dict(jax_ssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rs = np.random.default_rng(0)
    H = ssm.mamba2_dims(cfg)[1]
    u = lambda lo, hi, shape: jnp.asarray(rs.uniform(lo, hi, shape),
                                          jnp.float32)
    jp["a_log"] = u(-1.0, 1.5, (H,))
    jp["dt_bias"] = u(-1.0, 1.0, (H,))
    jp["d_skip"] = u(0.5, 1.5, (H,))
    jp["conv_b"] = u(-0.1, 0.1, jp["conv_b"].shape)
    jp["norm"] = u(-0.5, 0.5, jp["norm"].shape)
    p = {k: _t(np.asarray(v, np.float32)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def test_dims_and_init_match_jax(layer):
    jcfg, cfg, jp, _ = layer
    assert ssm.mamba2_dims(cfg) == jax_ssm.mamba2_dims(jcfg) == (512, 8, 544)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), bf,
                        torch.bfloat16, "cpu")
    jshapes = jax.eval_shape(lambda k: jax_ssm.init_mamba2(
        k, dataclasses.replace(jcfg, dtype="bfloat16"), jnp.bfloat16),
        jax.random.PRNGKey(0))
    assert sorted(p) == sorted(jshapes)
    for k, v in jshapes.items():
        assert tuple(p[k].shape) == tuple(v.shape), k
        assert str(p[k].dtype).replace("torch.", "") == str(v.dtype), k
    for k in ("a_log", "d_skip", "dt_bias"):
        assert p[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# the conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    rs = np.random.default_rng(1)
    B, T, C, W = 2, 11, 40, 4
    x = rs.standard_normal((B, T, C), dtype=np.float32)
    w = rs.standard_normal((W, C), dtype=np.float32) * 0.3
    b = rs.standard_normal(C).astype(np.float32) * 0.1
    st = rs.standard_normal((B, W - 1, C), dtype=np.float32) \
        if carried else None
    y, win = ssm._causal_conv(_t(x), _t(w), _t(b),
                              None if st is None else _t(st))
    jy, jwin = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    assert win.shape == (B, T, W - 1, C)
    _close(y, jy)
    np.testing.assert_array_equal(_np(win), np.asarray(jwin))
    np.testing.assert_array_equal(_np(win[:, -1, -1]), x[:, -1])


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, S, B=2, H=3, ds=16, hd=8, strong=False):
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    # strong: log-decays down to about -20 a step (dt * A of a fast head)
    w = -np.exp(r(B, S, H) * (1.5 if strong else 0.5)
                + (1.5 if strong else -1.0))
    return dict(r=r(B, S, ds), k=r(B, S, ds), v=r(B, S, H, hd),
                w=w.astype(np.float32), s0=r(B, H, ds, hd) * 0.3)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S", [11, 16, 37])
def test_ssd_chunked_matches_jax(S, init, strong):
    c = _ssd_inputs(2, S, strong=strong)
    s0 = c["s0"] if init else None
    o, st = ssm.mamba2_ssd_chunked(
        _t(c["r"]), _t(c["k"]), _t(c["v"]), _t(c["w"]),
        initial_state=None if s0 is None else _t(s0), chunk=16)
    jo, jst = jax_ssm.mamba2_ssd_chunked(
        jnp.asarray(c["r"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["w"]),
        initial_state=None if s0 is None else jnp.asarray(s0), chunk=16)
    assert o.shape == (2, S, 3, 8) and st.shape == (2, 3, 16, 8)
    assert st.dtype == torch.float32
    _close(o, jo)
    _close(st, jst)


def _broadcast(c):
    """The seq scan's operands: B and C over the heads (views), the
    scalar decay as (B, T, H, 1)."""
    B, T, H, _ = c["v"].shape
    ds = c["k"].shape[-1]
    r, k = (torch.from_numpy(c[n])[:, :, None].expand(B, T, H, ds)
            for n in ("r", "k"))
    return r, k, _t(c["v"]), _t(c["w"])[..., None]


@pytest.mark.parametrize("init", [False, True])
def test_seq_post_readout_matches_jax(init):
    c = _ssd_inputs(3, 6, strong=True)
    s0 = c["s0"] if init else None
    r, k, v, w = _broadcast(c)
    o, states = ssm.decay_attention_seq(
        r, k, v, w, initial_state=None if s0 is None else _t(s0),
        readout="post")
    jo, jstates = jax_ssm.decay_attention_seq(
        *(jnp.asarray(np.ascontiguousarray(_np(t))) for t in (r, k, v, w)),
        initial_state=None if s0 is None else jnp.asarray(s0),
        readout="post")
    assert states.shape == (2, 6, 3, 16, 8)
    _close(o, jo)
    _close(states, jstates)


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_chunked_equals_seq_in_the_port(strong):
    c = _ssd_inputs(4, 37, strong=strong)
    o, st = ssm.mamba2_ssd_chunked(_t(c["r"]), _t(c["k"]), _t(c["v"]),
                                   _t(c["w"]), initial_state=_t(c["s0"]),
                                   chunk=16)
    so, states = ssm.decay_attention_seq(*_broadcast(c),
                                         initial_state=_t(c["s0"]),
                                         readout="post")
    _close(o, so)
    _close(st, states[:, -1])


def test_mask_decay_inputs_matches_jax_at_each_rank():
    rs = np.random.default_rng(5)
    mask = np.array([[True] * 5 + [False] * 2, [True] * 3 + [False] * 4])
    for w_shape, k_shape in (((2, 7, 3), (2, 7, 16)),
                             ((2, 7, 3, 4), (2, 7, 3, 4))):
        w = rs.standard_normal(w_shape, dtype=np.float32)
        k = rs.standard_normal(k_shape, dtype=np.float32)
        tw, tk = ssm._mask_decay_inputs(_t(mask), _t(w), _t(k))
        jw, jk = jax_ssm._mask_decay_inputs(jnp.asarray(mask),
                                            jnp.asarray(w), jnp.asarray(k))
        np.testing.assert_array_equal(_np(tw), np.asarray(jw))
        np.testing.assert_array_equal(_np(tk), np.asarray(jk))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _states(cfg, B, seed):
    """Carried (ssd_state, conv_win), small and non-zero."""
    s = cfg.ssm
    _, H, C = ssm.mamba2_dims(cfg)
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((B, H, s.d_state, s.head_dim),
                               dtype=np.float32) * 0.1,
            rs.standard_normal((B, s.conv_width - 1, C),
                               dtype=np.float32) * 0.5)


def _run(layer, x, mode, states=None, valid_len=None):
    """Both sides' mamba2_fwd on the same inputs."""
    jcfg, cfg, jp, p = layer
    ssd0, conv0 = states if states is not None else (None, None)
    opt = lambda a, f: None if a is None else f(a)
    out, new = ssm.mamba2_fwd(p, cfg, _t(x), mode=mode,
                              ssd_state=opt(ssd0, _t),
                              conv_state=opt(conv0, _t),
                              valid_len=opt(valid_len, _t))
    jout, jnew = jax_ssm.mamba2_fwd(jp, jcfg, jnp.asarray(x), mode=mode,
                                    ssd_state=opt(ssd0, jnp.asarray),
                                    conv_state=opt(conv0, jnp.asarray),
                                    valid_len=opt(valid_len, jnp.asarray))
    return out, new, jout, jnew


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_mamba2_full_matches_jax(layer, ragged, carried):
    """Full mode, S = 37 (two chunks and a tail); ``ragged``: the second
    row is right-padded past 20 and length-masked."""
    cfg = layer[1]
    x = np.random.default_rng(6).standard_normal((2, 37, cfg.d_model),
                                                 dtype=np.float32)
    vl = np.array([37, 20], np.int32) if ragged else None
    out, new, jout, jnew = _run(layer, x, "full",
                                _states(cfg, 2, 7) if carried else None, vl)
    _close(out[0], jout[0])
    _close(out[1, :20], jout[1, :20])
    assert new["ssd_state"].shape == (2, 8, 16, 64)
    assert new["conv_win"].shape == (2, 3, 544)
    for key in ("ssd_state", "conv_win"):
        _close(new[key], jnew[key])


def test_mamba2_verify_matches_jax(layer):
    cfg = layer[1]
    x = np.random.default_rng(8).standard_normal((2, 5, cfg.d_model),
                                                 dtype=np.float32)
    out, new, jout, jnew = _run(layer, x, "verify", _states(cfg, 2, 9))
    assert new["ssd_state"].shape == (2, 5, 8, 16, 64)
    assert new["conv_win"].shape == (2, 5, 3, 544)
    _close(out, jout)
    for key in ("ssd_state", "conv_win"):
        _close(new[key], jnew[key])


def test_padded_prefill_equals_exact_within_tolerance(layer):
    """A right-padded prefill (pads of 1.0, as JAX's unit test has them)
    with ``valid_len`` leaves the states of the exact-length one, within
    the tolerance: the row's other operations run at another length."""
    _, cfg, _, p = layer
    rs = np.random.default_rng(10)
    x = rs.standard_normal((2, 11, cfg.d_model), dtype=np.float32)
    xp = np.pad(x, ((0, 0), (0, 21), (0, 0)), constant_values=1.0)
    _, exact = ssm.mamba2_fwd(p, cfg, _t(x), mode="full")
    _, masked = ssm.mamba2_fwd(p, cfg, _t(xp), mode="full",
                               valid_len=torch.full((2,), 11))
    for key in ("ssd_state", "conv_win"):
        np.testing.assert_allclose(_np(masked[key]), _np(exact[key]),
                                   atol=1e-5, rtol=1e-5)


def test_full_prefix_then_verify_equals_full(layer):
    """``tests/test_ssm.py::test_layer_full_vs_verify_states``'s property
    (32 tokens in full mode, then 4 in verify mode from its states, equal
    to one full pass over 36), in the port and against JAX's verify."""
    cfg = layer[1]
    S1, S2 = 32, 4
    x = np.random.default_rng(11).standard_normal((2, S1 + S2, cfg.d_model),
                                                  dtype=np.float32)
    o_full, _, _, _ = _run(layer, x, "full")
    _, st1, _, jst1 = _run(layer, x[:, :S1], "full")
    o2, new2, jo2, jnew2 = _run(
        layer, x[:, S1:], "verify",
        (_np(st1["ssd_state"]), _np(st1["conv_win"])))
    np.testing.assert_allclose(_np(o2), _np(o_full[:, S1:]), atol=2e-4,
                               rtol=1e-2)
    _close(o2, jo2)
    for key in ("ssd_state", "conv_win"):
        _close(st1[key], jst1[key])
        _close(new2[key], jnew2[key])
