"""The port's optimizer and corpus against the JAX package (CPU).

* ``adamw_update``: three updates from the same grads on a tree of fp32
  and bf16 leaves, params within relative 1e-6 of JAX's and the moments
  fp32 whatever the param dtype; ``clip_by_global_norm`` (norm and the
  clipped grads) and ``cosine_schedule`` at steps 0, 1, warmup, warmup+1
  and total likewise; JAX's own optimizer checks (``tests/
  test_training.py``) hold for the port;
* ``sample_corpus`` and ``DataPipeline`` (batches, eval batch, shards)
  equal JAX's bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.data import synthetic as syn  # noqa: E402
from repro_torch.training import optim  # noqa: E402

REL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree(rs, dtype_j, dtype_t):
    shapes = {"a": (5, 7), "b": [(3,), (2, 4, 3)], "c": {"x": (11,)}}
    arrs = {"a": rs.standard_normal(shapes["a"]),
            "b": [rs.standard_normal(s) for s in shapes["b"]],
            "c": {"x": rs.standard_normal(shapes["c"]["x"])}}
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype_j), arrs)
    tt = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(jnp.asarray(a, dtype_j), np.float32),
                               dtype=dtype_t), arrs)
    return jt, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    rs = np.random.default_rng(0)
    jp, tp = _tree(rs, jnp.dtype(dtype), getattr(torch, dtype))
    jopt, topt = joptim.init_adamw(jp), optim.init_adamw(tp)
    for i in range(3):
        jg, tg = _tree(rs, jnp.dtype(dtype), getattr(torch, dtype))
        lr = 1e-2 * (i + 1)
        jp, jopt = joptim.adamw_update(jg, jopt, jp, lr, weight_decay=0.01)
        tp, topt = optim.adamw_update(tg, topt, tp, lr, weight_decay=0.01)
    for w, g in zip(jax.tree_util.tree_leaves(jp),
                    optim.tree_leaves(tp)):
        assert g.dtype == getattr(torch, dtype)
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= REL
    for jm, tm in ((jopt.mu, topt.mu), (jopt.nu, topt.nu)):
        for w, g in zip(jax.tree_util.tree_leaves(jm), optim.tree_leaves(tm)):
            assert g.dtype == torch.float32
            assert _rel(g.numpy(), w) <= REL
    assert int(topt.step) == int(jopt.step) == 3


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    jg, tg = _tree(np.random.default_rng(1), jnp.float32, torch.float32)
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = optim.clip_by_global_norm(tg, max_norm)
    assert _rel(float(tn), float(jn)) <= REL
    for w, g in zip(jax.tree_util.tree_leaves(jc), optim.tree_leaves(tc)):
        assert _rel(g.numpy(), w) <= REL


@pytest.mark.parametrize("warmup,total", [(10, 110), (50, 500), (1, 3)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in sorted({0, 1, warmup, warmup + 1, total, total + 5}):
        want = float(joptim.cosine_schedule(jnp.asarray(step), peak_lr=3e-3,
                                            warmup=warmup, total=total,
                                            floor=1e-5))
        got = float(optim.cosine_schedule(torch.tensor(step), peak_lr=3e-3,
                                          warmup=warmup, total=total,
                                          floor=1e-5))
        assert abs(got - want) <= REL * max(abs(want), 1e-12), (step, got,
                                                                 want)


def test_port_optimizer_checks():
    """JAX's own optimizer checks, on the port."""
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = optim.init_adamw(params)
    for _ in range(300):
        params, opt = optim.adamw_update({"x": 2 * params["x"]}, opt, params,
                                         0.1)
    assert float(params["x"].abs().max()) < 1e-2
    s = lambda t: float(optim.cosine_schedule(t, peak_lr=1.0, warmup=10,
                                              total=110))
    assert s(0) == 0.0 and abs(s(10) - 1.0) < 1e-6 and s(60) < 1.0
    assert s(110) < 1e-6 + 1e-3
    clipped, gn = optim.clip_by_global_norm({"a": torch.full((10,), 10.0)})
    assert abs(float(gn) - np.sqrt(1000.0)) < 1e-3
    assert abs(float(clipped["a"].norm()) - 1.0) < 1e-4


@pytest.mark.parametrize("vocab,branch,peak,seed", [
    (2048, 4, 0.7, 0), (512, 3, 0.5, 7), (262144, 4, 0.7, 0)])
def test_sample_corpus_bitwise(vocab, branch, peak, seed):
    args = dict(vocab_size=vocab, branch=branch, peak=peak, seed=seed)
    want = jsyn.sample_corpus(jsyn.MarkovSpec(**args), 9, 70, seed=3)
    got = syn.sample_corpus(syn.MarkovSpec(**args), 9, 70, seed=3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_data_pipeline_bitwise(shard):
    kw = dict(seq_len=48, batch_size=6, n_train=40, n_eval=8, seed=5,
              shard_index=shard[0], shard_count=shard[1])
    jp = jsyn.DataPipeline(jsyn.MarkovSpec(2048, branch=4, peak=0.7), **kw)
    tp = syn.DataPipeline(syn.MarkovSpec(2048, branch=4, peak=0.7), **kw)
    for a, b in zip(jp.train_batches(4), tp.train_batches(4)):
        assert np.array_equal(a, b)
    assert np.array_equal(jp.eval_batch(4), tp.eval_batch(4))
    assert np.array_equal(jp.eval_batch(), tp.eval_batch())
