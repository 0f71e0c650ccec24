"""K6's chunk-parallel decomposition in plain PyTorch
(``kernels/linear_attn_chunk/ref.py::decay_attention_chunk_parallel``),
the form the CUDA kernel runs: every chunk's intra-chunk part at once,
its scores from secondary chunks of 16 (pairwise diagonal blocks,
off-diagonal blocks factored through the end of the earlier sub-chunk),
then a scan of the state across chunks.

Held against the port's ``decay_attention_chunked`` (the wrapper's CPU
path), the JAX kernel ``linear_attn_bshd`` in interpret mode, and the
recurrence (the port's ``linear_attn_ref`` from a zero state, JAX's
``decay_attention_seq`` from an initial state), fp32, with the bound of
``tests/test_torch_linear_attn_kernel.py``: max |o - ref| / max |ref|
below 1e-4, 1e-3 for strong decay; final states likewise.  Cases: u on
and off, an initial state, S not a chunk multiple, B = 2, chunks 16 and
64, and the strong-decay regime (log-decay down to -20 a step), where
every factor of the factorisation must be at most 1 and the output
finite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.linear_attn_chunk.ref import (  # noqa: E402
    decay_attention_chunk_parallel, decay_attention_chunked,
    linear_attn_ref)

torch.set_num_threads(2)


def _case(seed, B, S, H, d, *, use_u, init, strong=False):
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.standard_normal(s, dtype=np.float32)
    w = (np.maximum(-np.exp(f(B, S, H, d) * 1.5 + 1.0), -20.0) if strong
         else -np.exp(f(B, S, H, d) * 0.5)).astype(np.float32)
    return dict(r=f(B, S, H, d), k=f(B, S, H, d), v=f(B, S, H, d), w=w,
                u=f(H, d) * 0.1 if use_u else None,
                s0=f(B, H, d, d) * 0.1 if init else None)


def _t(c):
    return [None if x is None else torch.from_numpy(x) for x in c.values()]


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref))) / (float(np.max(np.abs(ref)))
                                             + 1e-6)


def _jax_seq(c):
    """JAX's per-token recurrence from the initial state: (o, final)."""
    import jax.numpy as jnp
    from repro.models.ssm import decay_attention_seq

    j = [None if x is None else jnp.asarray(x) for x in c.values()]
    o, states = decay_attention_seq(*j)
    return np.asarray(o), np.asarray(states[:, -1])


def _jax_kernel(c, chunk):
    import jax.numpy as jnp
    from repro.kernels.linear_attn_chunk.ops import linear_attn_bshd

    j = [None if x is None else jnp.asarray(x) for x in c.values()]
    return np.asarray(linear_attn_bshd(*j[:5], chunk=chunk, interpret=True))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("use_u", [True, False])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("B,S", [(1, 128), (2, 100)])
def test_matches_chunked_jax_and_recurrence(chunk, use_u, init, B, S):
    c = _case(S + chunk + 2 * use_u + init, B, S, 2, 32, use_u=use_u,
              init=init)
    o, st = decay_attention_chunk_parallel(*_t(c), chunk=chunk)
    o_ref, st_ref = decay_attention_chunked(*_t(c), chunk=chunk)
    assert o.shape == (B, S, 2, 32)
    assert _rel(o, o_ref) < 1e-4 and _rel(st, st_ref) < 1e-4
    o_seq, st_seq = _jax_seq(c)
    assert _rel(o, o_seq) < 1e-4 and _rel(st, st_seq) < 1e-4
    if not init:                   # the JAX kernel and the port's oracle
        assert _rel(o, _jax_kernel(c, chunk)) < 1e-4   # start from zero
        tr = lambda x: None if x is None else x.transpose(1, 2)
        t = _t(c)
        ref = linear_attn_ref(*(tr(x) for x in t[:4]), t[4]).transpose(1, 2)
        assert _rel(o, ref) < 1e-4


@pytest.mark.parametrize("init", [False, True])
def test_strong_decay_factors_stay_at_most_one(init):
    """Log-decays down to -20 a step: a factorisation against the chunk
    start would overflow; the one through each sub-chunk's end keeps
    every factor at most 1, and the output finite."""
    c = _case(30 + init, 1, 200, 2, 32, use_u=True, init=init, strong=True)
    factors = []
    o, st = decay_attention_chunk_parallel(*_t(c), chunk=64,
                                           factors=factors)
    assert len(factors) == 2 * 6 and all(
        bool((f <= 1.0).all()) for f in factors)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    o_ref, st_ref = decay_attention_chunked(*_t(c), chunk=64)
    assert _rel(o, o_ref) < 1e-3 and _rel(st, st_ref) < 1e-3
    o_seq, st_seq = _jax_seq(c)
    assert _rel(o, o_seq) < 1e-3 and _rel(st, st_seq) < 1e-3
    if not init:
        assert _rel(o, _jax_kernel(c, 64)) < 1e-3


def test_pure_padding_chunk_leaves_the_state_bit_for_bit():
    """A chunk of k = 0, w = 0 (the pad tail) decays by exp(0) = 1 and
    adds nothing: the state after it is the state before it."""
    c = _case(40, 1, 64, 2, 32, use_u=True, init=True)
    _, st = decay_attention_chunk_parallel(*_t(c), chunk=64)
    pad = {n: np.concatenate([x, np.zeros_like(x) if n in "kw" else x], 1)
           if n in "rkvw" else x for n, x in c.items()}
    _, st_pad = decay_attention_chunk_parallel(*_t(pad), chunk=64)
    assert torch.equal(st, st_pad)
