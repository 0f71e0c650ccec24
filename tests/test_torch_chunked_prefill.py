"""Chunked (resumable) prefill and the bucketed engine of the port against
the JAX reference and the port's own serving invariants (DESIGN.md §8).

Against JAX (params JAX-initialised and converted, fp32):

* ``join_slot_chunk`` and ``paged_join_slot_chunk``, chunk by chunk into
  a slot that held another request before: every cache row (attention
  and recurrent state) within atol = rtol = 1e-5 (1e-4 for rwkv6's
  states, whose chunked scan sums in another order), ``cache_len`` and
  the first token exactly;
* the port's chunked engines (dense and paged, chunk 8) give the JAX
  chunked engine's greedy streams exactly on reduced minitron-4b and
  rwkv6-1.6b.

The port's own invariants (``tests/test_chunked_prefill.py``'s cases, the
synchronous loop only), on reduced minitron-4b with a 16-token vocabulary
(random heads then get candidates accepted), against the port's serial
``generate()``, request by request:

* dense and paged chunked engines at chunk 8 and 16, a pool that preempts
  mid-prefill, chunked == unchunked, several chunks per step, budget
  validation, TTFT/ITL samples;
* rwkv6 chunked (chunks snapped up to the scan's chunk) and bucketed;
* deepseek-v2-lite (MLA + MoE) chunked while its routing stays under
  capacity (DESIGN.md §8's MoE exception);
* ``BucketedEngine`` on each;
* a chunk writes only its own positions of the slot's row (the port
  writes in place and has no ``commit_chunk``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import speculative as jax_spec  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import paged as jax_paged  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.speculative import (PAD_TOKEN, generate,  # noqa: E402
                                          init_pool_state, join_slot_chunk)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.engine import (BucketedEngine,  # noqa: E402
                                        PagedSpeculativeEngine, Request,
                                        SpeculativeEngine)
from repro_torch.serving.paged import (init_paged_state,  # noqa: E402
                                       paged_join_slot_chunk)

torch.set_num_threads(2)
VOCAB = 16
MAX_LEN = 160
BS = 16
LENS, BUDGETS = (16, 23, 9, 96, 32), (12, 14, 10, 8, 8)


def _cfgs(arch, **kw):
    """(JAX cfg, port cfg): the reduced config in fp32, plus ``kw``."""
    return [dataclasses.replace(get(arch).reduced(), dtype="float32", **kw)
            for get in (jax_get_config, get_config)]


def _model(arch, **kw):
    """(jax cfg, port cfg, jax params, jax draft, port params, port draft,
    tree), JAX-initialised."""
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jdp = jax_init_draft(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    dp = bridge.draft_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
    return jcfg, cfg, jparams, jdp, params, dp, tree_for(cfg)


@pytest.fixture(scope="module")
def minitron():
    return _model("minitron-4b", vocab_size=VOCAB)


@pytest.fixture(scope="module")
def rwkv6():
    return _model("rwkv6-1.6b", vocab_size=VOCAB)


def _stream(toks):
    return [int(t) for t in np.asarray(toks)[0] if t != PAD_TOKEN]


def _serial(model, lens, budgets, seed=0):
    """(prompt, budget, the port's serial generate() stream) per request."""
    _, cfg, _, _, params, dp, tree = model
    rs = np.random.RandomState(seed)
    refs = []
    for n, b in zip(lens, budgets):
        p = rs.randint(0, cfg.vocab_size, n).astype(np.int32)
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(p)[None].long(),
                           max_new_tokens=b, max_len=MAX_LEN)
        refs.append((p, b, _stream(t)[:b]))
    return refs


@pytest.fixture(scope="module")
def serial(minitron):
    """The ragged workload with one long prompt (~4x the mean)."""
    return _serial(minitron, LENS, BUDGETS)


def _requests(refs):
    return [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]


def _serve(eng, refs, max_batch=3):
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=max_batch)
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.done and r.output == ref and len(r.output) == budget
    return stats


# ---------------------------------------------------------------------------
# the chunk joins against JAX
# ---------------------------------------------------------------------------


def _view(end: int) -> int:
    v = 64
    while v < min(end, MAX_LEN):
        v *= 2
    return min(v, MAX_LEN)


def _chunked_joins(model, paged: bool, C: int, prompts, slot: int):
    """Prefill ``prompts`` one after another into ``slot`` of a 3-slot pool,
    chunk by chunk, through JAX's and the port's chunk join.  Returns the
    two states and the first tokens of each."""
    jcfg, cfg, jparams, jdp, params, dp, _ = model
    if paged:
        M = MAX_LEN // BS
        table = np.zeros(M, np.int32)
        table[:] = np.random.RandomState(3).permutation(np.arange(1, 25))[:M]
        jst = jax_paged.init_paged_state(jparams, jdp, jcfg, 3, 25, BS,
                                         jax.random.PRNGKey(0))
        st = init_paged_state(params, dp, cfg, 3, 25, BS, "cpu")
    else:
        jst = jax_spec.init_pool_state(jparams, jdp, jcfg, 3, MAX_LEN,
                                       jax.random.PRNGKey(0))
        st = init_pool_state(params, dp, cfg, 3, MAX_LEN, "cpu")
    toks = []
    for prompt in prompts:
        n = len(prompt)
        ctx = np.zeros(-(-n // C) * C, np.int32)
        ctx[:n] = prompt
        for start in range(0, len(ctx), C):
            chunk, final = ctx[start:start + C], start + C >= len(ctx)
            view = _view(start + C)
            if paged:
                jst = jax_paged.paged_join_slot_chunk(
                    jparams, jdp, jcfg, jst, jnp.asarray(chunk),
                    jnp.int32(start), n, slot, jnp.asarray(table),
                    final=final, view_blocks=-(-view // BS))
                st = paged_join_slot_chunk(
                    params, dp, cfg, st, torch.from_numpy(chunk), start, n,
                    slot, torch.from_numpy(table), final=final,
                    view_blocks=-(-view // BS))
            else:
                jst = jax_spec.join_slot_chunk(
                    jparams, jdp, jcfg, jst, jnp.asarray(chunk),
                    jnp.int32(start), n, slot, final=final, view_len=view)
                st = join_slot_chunk(params, dp, cfg, st,
                                     torch.from_numpy(chunk), start, n, slot,
                                     final=final, view_len=view)
        toks.append((int(jst.last_token[slot]), int(st.last_token[slot])))
    return jst, st, toks


def _assert_states_close(jst, st, paged: bool, state_tol: float):
    jgroups = jst.pools if paged else jst.cache
    groups = st.pools if paged else st.cache
    for jg, g in zip(jgroups, groups):
        for key, arr in g.items():
            tol = 1e-5 if key in ("k", "v") else state_tol
            np.testing.assert_allclose(arr.numpy(), np.asarray(jg[key]),
                                       atol=tol, rtol=tol, err_msg=key)
    if st.prefix_k is not None:
        for a, ja in ((st.prefix_k, jst.prefix_k),
                      (st.prefix_v, jst.prefix_v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-5,
                                       rtol=1e-5)
    np.testing.assert_array_equal(st.cache_len.numpy(),
                                  np.asarray(jst.cache_len))
    np.testing.assert_allclose(st.last_hidden.numpy(),
                               np.asarray(jst.last_hidden), atol=state_tol,
                               rtol=state_tol)


@pytest.mark.parametrize("paged", [False, True])
def test_join_slot_chunk_matches_jax(minitron, paged):
    """Two prompts into slot 1 in chunks of 16: the second finds the
    first's entries past its own length (masked, never read)."""
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in (40, 21)]
    jst, st, toks = _chunked_joins(minitron, paged, 16, prompts, slot=1)
    assert all(a == b for a, b in toks)
    _assert_states_close(jst, st, paged, 1e-5)


@pytest.mark.parametrize("paged", [False, True])
def test_rwkv6_join_slot_chunk_matches_jax(rwkv6, paged):
    """The carried recurrent state is zeroed for a new request's first
    chunk and scanned on across chunks (K6's plain version from the
    carried state)."""
    C = rwkv6[1].ssm.chunk_size
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in (40, 20)]
    jst, st, toks = _chunked_joins(rwkv6, paged, C, prompts, slot=2)
    assert all(a == b for a, b in toks)
    _assert_states_close(jst, st, paged, 1e-4)


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_writes_only_its_positions(minitron, paged):
    """One non-final chunk at [16, 32) of slot 1: no other position of any
    row (dense) or pool block (paged) changes; the write goes straight
    into the pool, so there is nothing to commit."""
    _, cfg, _, _, params, dp, _ = minitron
    C, start = 16, 16
    chunk = torch.from_numpy(np.arange(C, dtype=np.int32) % VOCAB)
    if paged:
        st = init_paged_state(params, dp, cfg, 3, 12, BS, "cpu")
        groups, prefix = st.pools, (st.prefix_k, st.prefix_v)
    else:
        st = init_pool_state(params, dp, cfg, 3, MAX_LEN, "cpu")
        groups, prefix = st.cache, (st.prefix_k, st.prefix_v)
    for g in groups:
        for a in g.values():
            a.normal_()
    for a in prefix:
        a.normal_()
    arrays = [a for g in groups for a in g.values()] + list(prefix)
    before = [a.clone() for a in arrays]
    table = torch.tensor([5, 7, 2] + [0] * 7, dtype=torch.int32)
    if paged:
        paged_join_slot_chunk(params, dp, cfg, st, chunk, start, 100, 1,
                              table, final=False, view_blocks=4)
    else:
        join_slot_chunk(params, dp, cfg, st, chunk, start, 100, 1,
                        final=False, view_len=64)
    assert int(st.cache_len[1]) == start + C
    for a, b in zip(arrays, before):
        changed = a != b
        assert changed.any(), "the chunk wrote nothing"
        # a group's arrays carry a layer axis, the prefix pools none
        lead = (slice(None),) if a.dim() == 5 else ()
        if paged:        # logical [16, 32) is the table's block 1: block 7
            changed[lead + (7,)] = False
        else:
            changed[lead + (1, slice(start, start + C))] = False
        assert not changed.any()


# ---------------------------------------------------------------------------
# engines against JAX's chunked engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,paged", [("minitron-4b", False),
                                        ("minitron-4b", True),
                                        ("rwkv6-1.6b", False)])
def test_chunked_engine_matches_jax_chunked_engine(minitron, rwkv6, arch,
                                                   paged):
    model = minitron if arch == "minitron-4b" else rwkv6
    jcfg, cfg, jparams, jdp, params, dp, tree = model
    rs = np.random.RandomState(12)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32)
               for n in (16, 23, 9, 40)]
    budgets = (12, 14, 10, 8)
    kw = dict(max_len=MAX_LEN, prefill_chunk=8)
    if paged:
        jeng = jax_engine.PagedSpeculativeEngine(
            jparams, jdp, jcfg, tree, block_size=BS, inflight=1, **kw)
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS,
                                     device="cpu", **kw)
    else:
        jeng = jax_engine.SpeculativeEngine(jparams, jdp, jcfg, tree,
                                            inflight=1, **kw)
        eng = SpeculativeEngine(params, dp, cfg, tree, device="cpu", **kw)
    jreqs = [jax_engine.Request(prompt=p.copy(), max_new_tokens=b)
             for p, b in zip(prompts, budgets)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    jstats = jeng.serve(jreqs, max_batch=3)
    stats = eng.serve(reqs, max_batch=3)
    assert eng.prefill_chunk == jeng.prefill_chunk
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert (stats.prefill_chunks, stats.prefill_tokens) == (
        jstats.prefill_chunks, jstats.prefill_tokens)


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16])
def test_dense_chunked_matches_serial(minitron, serial, chunk):
    _, cfg, _, _, params, dp, tree = minitron
    eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                            prefill_chunk=chunk, device="cpu")
    stats = _serve(eng, serial)
    # every prompt really was split: the 96-token one alone needs 96/chunk
    assert stats.prefill_chunks == sum(-(-n // chunk) for n in LENS)
    assert stats.prefill_tokens == sum(LENS)
    assert stats.tokens_per_step > 1.0


@pytest.mark.parametrize("chunk", [8, 16])
def test_paged_chunked_matches_serial(minitron, serial, chunk):
    _, cfg, _, _, params, dp, tree = minitron
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, prefill_chunk=chunk,
                                 device="cpu")
    _serve(eng, serial)
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


def test_paged_chunked_preemption_mid_prefill(minitron):
    """A pool in which two long prompts cannot prefill side by side: the
    scheduler evicts a slot mid-prefill (partial prefill dropped, request
    requeued, restarted from chunk 0) and every stream is still exact."""
    _, cfg, _, _, params, dp, tree = minitron
    refs = _serial(minitron, (64, 64), (10, 10), seed=7)
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=8,
                                 prefill_chunk=16, device="cpu")
    evicted = []
    preempt = eng._preempt

    def spy(si, slots, active, pending):
        evicted.append(si in eng._prefills)
        preempt(si, slots, active, pending)

    eng._preempt = spy
    stats = _serve(eng, refs, max_batch=2)
    assert stats.preemptions >= 1 and any(evicted), \
        "the pool should force an eviction mid-prefill"
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


def test_chunked_vs_unchunked_identical_streams(minitron, serial):
    _, cfg, _, _, params, dp, tree = minitron
    outs = []
    for kw in ({}, {"prefill_chunk": 8}):
        reqs = _requests(serial)
        SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                          device="cpu", **kw).serve(reqs, max_batch=3)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_rwkv6_chunked_and_bucketed_match_serial(rwkv6):
    """Chunks at the scan's chunk and twice it, a chunk snapped up to it,
    bucket-padded whole-prompt joins and the bucketed engine: each equal
    to serial ``generate()``."""
    _, cfg, _, _, params, dp, tree = rwkv6
    refs = _serial(rwkv6, (12, 19, 70), (8, 10, 6))
    inner = cfg.ssm.chunk_size
    for chunk in (inner, 2 * inner, inner - 1):
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                prefill_chunk=chunk, device="cpu")
        assert eng.prefill_chunk == -(-chunk // inner) * inner
        _serve(eng, refs, max_batch=2)
    _serve(PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                  block_size=BS, prefill_chunk=inner,
                                  device="cpu"), refs, max_batch=2)
    _serve(SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                             prefill_bucket=32, device="cpu"), refs,
           max_batch=2)
    _serve(BucketedEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                          device="cpu"), refs, max_batch=2)


def test_prefill_budget_validation(minitron):
    _, cfg, _, _, params, dp, tree = minitron
    with pytest.raises(ValueError, match="prefill_budget"):
        SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                          prefill_chunk=16, prefill_budget=8, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                          prefill_chunk=-1, device="cpu")
    eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                            prefill_chunk=16, device="cpu")
    assert eng.prefill_budget == 16


def test_prefill_budget_multiple_chunks_per_step(minitron, serial):
    """budget = 2 chunks: two chunks may ride beside one decode step (the
    96-token prompt's 12 chunks of 8 take 6 iterations, not 12): fewer
    loop iterations, the same streams."""
    _, cfg, _, _, params, dp, tree = minitron
    eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                            prefill_chunk=8, prefill_budget=16,
                            device="cpu")
    per_iter = []
    advance = eng._advance_prefills

    def spy(*a):
        n = eng.stats.prefill_chunks
        out = advance(*a)
        per_iter.append(eng.stats.prefill_chunks - n)
        return out

    eng._advance_prefills = spy
    _serve(eng, serial)
    assert max(per_iter) == 2 and sum(per_iter) == eng.stats.prefill_chunks


@pytest.mark.parametrize("paged", [False, True])
def test_request_done_at_its_first_token(minitron, serial, paged):
    """A request that its final chunk finishes outright (budget 1): its
    first token is read one step later, as the JAX engine reads it, so
    each request rides one step as a zombie row that emits nothing, and
    the next one waits for the next iteration's budget: the loop goes on
    (it is no pool deadlock)."""
    _, cfg, _, _, params, dp, tree = minitron
    refs = [(p, 1, ref[:1]) for p, _, ref in serial[:3]]
    kw = dict(max_len=MAX_LEN, prefill_chunk=32, device="cpu")
    eng = (PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS, **kw)
           if paged else SpeculativeEngine(params, dp, cfg, tree, **kw))
    stats = _serve(eng, refs, max_batch=1)
    assert stats.steps == 3 and stats.tokens == 0
    assert stats.prefill_chunks == 3


def test_ttft_and_itl_stats_populated(minitron, serial):
    """One TTFT per request and one ITL sample per token after the first,
    chunked and unchunked."""
    _, cfg, _, _, params, dp, tree = minitron
    for kw in ({}, {"prefill_chunk": 16}):
        eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                device="cpu", **kw)
        reqs = _requests(serial)
        stats = eng.serve(reqs, max_batch=3)
        assert len(stats.ttft_s) == len(reqs)
        assert all(t >= 0 for t in stats.ttft_s)
        assert len(stats.itl_s) == sum(len(r.output) - 1 for r in reqs)
        assert stats.p99_itl_s >= 0.0 and stats.mean_ttft_s >= 0.0
        for r in reqs:
            assert r.ttft_s is not None and r.ttft_s <= r.latency_s


@pytest.fixture(scope="module")
def deepseek():
    return _model("deepseek-v2-lite-16b", vocab_size=VOCAB)


@pytest.mark.parametrize("chunk", [8, 16])
def test_deepseek_chunked_matches_serial_under_capacity(deepseek, chunk):
    """MLA + MoE: a chunk boundary changes which tokens could overflow an
    expert's capacity, so chunked == serial holds while routing stays
    under capacity, as it does for these prompts at the reduced config
    (DESIGN.md §8)."""
    _, cfg, _, _, params, dp, tree = deepseek
    refs = _serial(deepseek, (12, 19, 25, 40), (8, 10, 6, 8))
    for paged in (False, True):
        kw = dict(max_len=MAX_LEN, prefill_chunk=chunk, device="cpu")
        eng = (PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS,
                                      **kw) if paged
               else SpeculativeEngine(params, dp, cfg, tree, **kw))
        _serve(eng, refs, max_batch=2)


def test_bucketed_engine_matches_serial(minitron, serial):
    """Exact-length buckets (two prompts share a length here), each batch
    prefilled at once and stepped to completion."""
    _, cfg, _, _, params, dp, tree = minitron
    refs = serial + [(serial[0][0][::-1].copy(), 9,
                      _serial_one(minitron, serial[0][0][::-1].copy(), 9))]
    eng = BucketedEngine(params, dp, cfg, tree, max_len=MAX_LEN, device="cpu")
    assert [len(b) for b in eng.bucket(_requests(refs), 3)] == [1, 2, 1, 1, 1]
    stats = _serve(eng, refs)
    assert stats.steps > 0 and len(stats.ttft_s) == len(refs)
    assert stats.tokens == sum(b for _, b, _ in refs) - len(refs)


def _serial_one(model, prompt, budget):
    _, cfg, _, _, params, dp, tree = model
    t, _, _ = generate(params, dp, cfg, tree,
                       torch.from_numpy(prompt)[None].long(),
                       max_new_tokens=budget, max_len=MAX_LEN)
    return _stream(t)[:budget]


@pytest.mark.parametrize("engine,extra", [
    ("paged", ["--prefill-chunk", "16"]),
    ("continuous", ["--prefill-chunk", "8", "--prefill-budget", "16"]),
    ("bucketed", [])])
def test_serve_launcher_chunked_and_bucketed(capsys, engine, extra):
    serve.main(["--arch", "minitron-4b", "--engine", engine, "--batch", "2",
                "--requests", "3", "--prompt-len", "24", "--ragged",
                "--max-new-tokens", "5", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert f"[serve] engine={engine} " in out and "tokens=12 " in out
    if extra:
        assert "prefill_chunks=" in out
