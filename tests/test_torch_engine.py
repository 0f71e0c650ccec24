"""Draft, verify, commit, generate and the serving engines of the port
against the JAX reference, on a tiny GQA Hydra++ config
(``minitron-4b.reduced()``, fp32) with a 16-token vocabulary, so that
random heads get candidates accepted and the commit moves entries.

* ``draft_tree_tokens``, ``greedy_verify`` and the dense and paged commit
  agree with JAX (tokens and paths exactly, log-probs and caches within
  ``atol = rtol = 1e-4``);
* ``generate()`` streams equal JAX ``generate()`` exactly under Hydra++,
  Hydra, Medusa and autoregressive decoding;
* on a ragged workload, the port's serial ``generate()`` and its dense
  and paged engines equal JAX serial ``generate()`` exactly, request by
  request, including a pool small enough to force preemption;
* the block allocator keeps the JAX allocator's invariants.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.heads import draft_tree_tokens as jax_draft  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.core.verify import greedy_verify as jax_greedy_verify  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving.cache import commit_cache as jax_commit  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.heads import draft_tree_tokens  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.core.verify import greedy_verify  # noqa: E402
from repro_torch.serving.cache import commit_cache  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request, SpeculativeEngine)
from repro_torch.serving.paged import NULL_BLOCK, BlockAllocator  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 16
MAX_LEN = 128
BS = 16
DRAFTS = {
    "hydra++": {},
    "hydra": dict(kind="hydra", n_mlp_layers=1, prefix_attention=False),
    "medusa": dict(kind="medusa", n_mlp_layers=1, prefix_attention=False),
}


def _cfgs(draft: str):
    out = []
    for get in (jax_get_config, get_config):
        c = get("minitron-4b").reduced()
        out.append(dataclasses.replace(
            c, dtype="float32", vocab_size=VOCAB,
            draft=dataclasses.replace(c.draft, **DRAFTS[draft])))
    return out


@pytest.fixture(scope="module")
def models():
    """Per draft kind: (jax cfg, port cfg, jax params, jax draft params,
    port params, port draft params), JAX-initialised."""
    jparams = None
    out = {}
    for i, draft in enumerate(DRAFTS):
        jcfg, cfg = _cfgs(draft)
        if jparams is None:
            jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
            params = bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        jdp = jax_init_draft(jax.random.PRNGKey(10 + i), jcfg)
        dp = bridge.draft_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
        out[draft] = (jcfg, cfg, jparams, jdp, params, dp)
    return out


def _np(x):
    return x.detach().numpy()


# ---------------------------------------------------------------------------
# draft / verify / commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", list(DRAFTS))
def test_draft_tree_tokens_matches_jax(models, draft):
    jcfg, cfg, jparams, jdp, params, dp = models[draft]
    tree = tree_for(cfg)
    rs = np.random.default_rng(0)
    h = rs.standard_normal((3, cfg.d_model), dtype=np.float32)
    last = rs.integers(0, VOCAB, 3).astype(np.int32)
    jt, jlp = jax_draft(jdp, jcfg, jparams, tree, jnp.asarray(h),
                        jnp.asarray(last))
    t, lp = draft_tree_tokens(dp, cfg, params, tree, torch.from_numpy(h),
                              torch.from_numpy(last).long())
    np.testing.assert_array_equal(_np(t), np.asarray(jt))
    np.testing.assert_allclose(_np(lp), np.asarray(jlp), **TOL)


def test_greedy_verify_matches_jax():
    tree = tree_for(_cfgs("hydra++")[1])
    rs = np.random.default_rng(1)
    B, T = 6, tree.size
    logits = rs.standard_normal((B, T, VOCAB), dtype=np.float32)
    am = logits.argmax(-1)
    # candidates that copy their parent's argmax half of the time
    toks = rs.integers(0, VOCAB, (B, T))
    for i in range(1, T):
        hit = rs.random(B) < 0.6
        toks[hit, i] = am[hit, tree.parents[i]]
    toks = toks.astype(np.int32)
    jr = jax_greedy_verify(tree, jnp.asarray(toks), jnp.asarray(logits))
    r = greedy_verify(tree, torch.from_numpy(toks).long(),
                      torch.from_numpy(logits))
    assert int(np.asarray(jr.n_accept).max()) >= 2
    for a, b in zip(jr, r):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("paged", [False, True])
def test_commit_matches_jax(paged):
    """Accepted scratch entries move to the front of the scratch region;
    the source and destination ranges overlap."""
    rs = np.random.default_rng(2)
    L, B, D1, H, D = 2, 3, 5, 2, 4
    lens = np.array([3, 17, 30], np.int32)
    path = np.array([[0, 1, 4, 6, 6], [0, 2, 2, 2, 2], [0, 1, 3, 5, 7]],
                    np.int32)
    if paged:
        table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
        arr = rs.standard_normal((L, 10, BS, H, D), dtype=np.float32)
        kw, tkw = ({"block_table": jnp.asarray(table)},
                   {"block_table": torch.from_numpy(table)})
    else:
        arr = rs.standard_normal((L, B, 48, H, D), dtype=np.float32)
        kw = tkw = {}
    cache = [{"k": arr, "v": arr * 2}]
    jc = jax_commit([{k: jnp.asarray(v) for k, v in cache[0].items()}],
                    jnp.asarray(lens), jnp.asarray(path),
                    jnp.asarray(path[:, -1] * 0 + 3), **kw)
    tc = commit_cache([{k: torch.from_numpy(v.copy())
                        for k, v in cache[0].items()}],
                      torch.from_numpy(lens), torch.from_numpy(path).long(),
                      **tkw)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[0][key]),
                                      np.asarray(jc[0][key]))


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


def _stream(toks):
    """Per row, the generated tokens with the PAD tails removed."""
    toks = np.asarray(toks)
    return [[int(t) for t in row if t != PAD_TOKEN] for row in toks]


@pytest.mark.parametrize("draft,spec", [("hydra++", True), ("hydra", True),
                                        ("medusa", True), ("hydra++", False)])
def test_generate_matches_jax(models, draft, spec):
    jcfg, cfg, jparams, jdp, params, dp = models[draft]
    tree = tree_for(cfg)
    rs = np.random.default_rng(3)
    prompt = rs.integers(0, VOCAB, (2, 12)).astype(np.int32)
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


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

LENS = (16, 23, 32, 9, 40, 12)
BUDGETS = (12, 14, 8, 10, 13, 9)


@pytest.fixture(scope="module")
def serial(models):
    """JAX serial generate() per request of a ragged workload; the port's
    serial generate() must give the same stream for every request."""
    jcfg, cfg, jparams, jdp, params, dp = models["hydra++"]
    tree = tree_for(cfg)
    rs = np.random.default_rng(4)
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


def _requests(refs):
    return [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]


def test_dense_engine_matches_serial_generate(serial):
    cfg, params, dp, tree, refs = serial
    eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                            device="cpu")
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=3)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    assert stats.steps > 0 and stats.tokens_per_step > 1.0


@pytest.mark.parametrize("num_blocks", [None, 6])
def test_paged_engine_matches_serial_generate(serial, num_blocks):
    """Dense-equivalent pool, and an oversubscribed one that must queue
    and preempt; every request still completes byte-exactly."""
    cfg, params, dp, tree, refs = serial
    # the synchronous loop: under inflight=2 admission budgets the
    # stale allowance and this pool queues without preempting
    # (tests/test_torch_engine_async.py preempts under the async loop)
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=num_blocks,
                                 inflight=1, device="cpu")
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=4)
    for r, (_, _, ref) in zip(reqs, refs):
        assert r.done and r.output == ref
    assert 0 < stats.peak_blocks_in_use <= stats.num_blocks - 1
    if num_blocks is None:
        assert stats.preemptions == 0
    else:
        assert stats.preemptions >= 1
        assert stats.pool_tokens < stats.dense_equiv_tokens


def test_request_exceeding_pool_rejected(serial):
    cfg, params, dp, tree, _ = serial
    big = Request(prompt=np.zeros(48, np.int32), max_new_tokens=40)
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=5, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        eng.serve([big], max_batch=1)


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------


def test_allocator_alloc_free_reuse():
    a = BlockAllocator(num_blocks=8, block_size=BS)
    assert a.usable_blocks == 7 and a.free_blocks == 7
    g1, g2 = a.alloc(3), a.alloc(2)
    assert len(set(g1) | set(g2)) == 5
    assert NULL_BLOCK not in g1 + g2
    a.free(g1)
    g3 = a.alloc(5)
    assert g3 is not None and set(g1) < set(g3)
    assert a.peak_in_use == 7


def test_allocator_exhaustion_is_all_or_nothing():
    a = BlockAllocator(num_blocks=4, block_size=BS)
    assert a.alloc(4) is None and a.free_blocks == 3
    assert a.alloc(3) is not None and a.alloc(1) is None


def test_allocator_rejects_double_free():
    a = BlockAllocator(num_blocks=4, block_size=BS)
    got = a.alloc(2)
    a.free(got)
    with pytest.raises(ValueError, match="free"):
        a.free(got)
    with pytest.raises(ValueError, match="free"):
        a.free([3])


def test_allocator_blocks_for():
    a = BlockAllocator(num_blocks=4, block_size=16)
    assert (a.blocks_for(1), a.blocks_for(16), a.blocks_for(17)) == (1, 1, 2)
