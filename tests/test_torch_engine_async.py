"""The port's async serve loop and live request queue (DESIGN.md §7),
against the port's serial ``generate()`` and against the JAX engine.

The port's own invariants (``tests/test_engine_async.py``'s cases and the
``inflight`` cases of ``tests/test_chunked_prefill.py``), on reduced
minitron-4b in fp32 with a 16-token vocabulary (random heads then get
candidates accepted), request by request against serial ``generate()``:

* dense ``inflight`` 1, 2 and 3 and paged 1 and 2 give the serial
  streams, with the window filled (``steps_in_flight == inflight``);
  the async loop is the default;
* ``submit``/``drain``, the oversized request refused, a live submit
  mid-serve, a generator source, a source's exception relayed with its
  pulled requests parked in the queue, the feeder thread reaped;
* paged preemption under ``inflight=2`` resumes byte-exact and leaks no
  block; rwkv6 under ``inflight=2``; chunked dense/paged at
  ``inflight=2``, a mid-prefill preemption, a request its final chunk
  finishes; the copy guarantee of ``snapshot`` (the JAX engine's
  ``_snapshot``);
* off CUDA ``capture_step`` never engages and changes no stream; one pool
  serves every ``serve`` call of an engine.

Against JAX (vicuna-tiny, fp32, 16-token vocabulary, JAX-initialised
parameters): the port's engines at ``inflight=2`` give the JAX engine's
streams and its step count, dense, paged with a forced preemption, and
chunked.  No test waits without a bound: sources are finite, the feeder
joins with a timeout.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.heads import init_draft_params  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request, SpeculativeEngine)
from repro_torch.serving.graph import snapshot  # noqa: E402

torch.set_num_threads(2)
VOCAB = 16
MAX_LEN = 160
BS = 16
LENS, BUDGETS = (16, 23, 32, 9, 40, 12), (24, 28, 16, 20, 26, 18)


def _model(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              vocab_size=VOCAB)
    return (cfg, init_params(cfg, seed=0, device="cpu"),
            init_draft_params(cfg, seed=1, device="cpu"), tree_for(cfg))


@pytest.fixture(scope="module")
def minitron():
    return _model("minitron-4b")


def _serial(model, lens, budgets, seed=0):
    """(prompt, budget, the port's serial generate() stream) per request."""
    cfg, params, dp, tree = model
    rs = np.random.RandomState(seed)
    refs = []
    for n, b in zip(lens, budgets):
        p = rs.randint(0, cfg.vocab_size, n).astype(np.int32)
        t, _, _ = generate(params, dp, cfg, tree,
                           torch.from_numpy(p)[None].long(),
                           max_new_tokens=b, max_len=MAX_LEN)
        refs.append((p, b, [int(x) for x in t[0] if x != PAD_TOKEN][:b]))
    return refs


@pytest.fixture(scope="module")
def serial(minitron):
    return _serial(minitron, LENS, BUDGETS)


def _requests(refs):
    return [Request(prompt=p.copy(), max_new_tokens=b) for p, b, _ in refs]


def _assert_all_match(reqs, refs, what):
    for r, (_, budget, ref) in zip(reqs, refs):
        assert r.output == ref, f"{what} diverged from serial generate"
        assert r.done and len(r.output) == budget


def _engine(model, paged=False, **kw):
    cfg, params, dp, tree = model
    kw.setdefault("max_len", MAX_LEN)
    if paged:
        return PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS,
                                      device="cpu", **kw)
    return SpeculativeEngine(params, dp, cfg, tree, device="cpu", **kw)


# ---------------------------------------------------------------------------
# async == sync == serial
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inflight", [1, 2, 3])
def test_dense_async_matches_serial(minitron, serial, inflight):
    eng = _engine(minitron, inflight=inflight)
    reqs = _requests(serial)
    stats = eng.serve(reqs, max_batch=3)
    _assert_all_match(reqs, serial, f"dense inflight={inflight}")
    assert stats.tokens == sum(len(r.output) - 1 for r in reqs)
    assert stats.steps_in_flight == inflight   # the window really filled
    assert stats.read_wait_s > 0.0
    assert len(stats.step_s) == stats.steps
    if inflight == 1:
        # every step's host bookkeeping runs with nothing in flight
        assert stats.host_stall_s > 0.0


@pytest.mark.parametrize("inflight", [1, 2])
def test_paged_async_matches_serial(minitron, serial, inflight):
    eng = _engine(minitron, paged=True, inflight=inflight)
    reqs = _requests(serial)
    stats = eng.serve(reqs, max_batch=3)
    _assert_all_match(reqs, serial, f"paged inflight={inflight}")
    assert stats.steps_in_flight == inflight
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


def test_async_is_default(minitron):
    for paged in (False, True):
        eng = _engine(minitron, paged=paged)
        assert eng.inflight == 2 and eng._stale_allowance == eng._max_emit
    with pytest.raises(ValueError, match="inflight"):
        _engine(minitron, inflight=0)


def test_stale_allowance_enters_every_capacity_check(minitron):
    """A request that fits the synchronous loop exactly is refused by the
    async one, whose up-front check budgets the zombie step's commits."""
    tree = minitron[3]
    sync = _engine(minitron, inflight=1, max_len=64)
    fits = Request(prompt=np.zeros(32, np.int32),
                   max_new_tokens=64 - 32 - tree.size)
    sync.submit(fits)
    with pytest.raises(ValueError, match="async staleness"):
        _engine(minitron, max_len=64).submit(fits)
    # paged: 32 + 40 tokens padded to 72, + 8 scratch = 5 blocks of 16;
    # the allowance needs a sixth
    exact = Request(prompt=np.zeros(32, np.int32), max_new_tokens=40)
    kw = dict(paged=True, num_blocks=6, prefill_bucket=8)
    _engine(minitron, inflight=1, **kw).submit(exact)
    with pytest.raises(ValueError, match="blocks"):
        _engine(minitron, **kw).submit(exact)


# ---------------------------------------------------------------------------
# the live queue
# ---------------------------------------------------------------------------


def test_submit_then_drain(minitron, serial):
    eng = _engine(minitron)
    reqs = _requests(serial)
    for r in reqs:
        eng.submit(r)
    stats = eng.drain(max_batch=3)
    _assert_all_match(reqs, serial, "submit/drain")
    assert len(stats.request_latency_s) == len(reqs)
    assert all(r.latency_s is not None and r.latency_s >= 0 for r in reqs)


def test_submit_rejects_oversized_request(minitron):
    eng = _engine(minitron, max_len=96)
    big = Request(prompt=np.zeros(48, np.int32), max_new_tokens=64)
    with pytest.raises(ValueError, match="cache slots"):
        eng.submit(big)
    assert not eng._queue


def test_live_submit_mid_serve(minitron, serial):
    """The tail arrives through a callable source only once the first
    request has finished, so it provably joins while steps are in
    flight."""
    eng = _engine(minitron)
    reqs = _requests(serial)
    head, tail = reqs[:2], reqs[2:]
    remaining = list(tail)

    def source():
        if not remaining:
            return None                        # stream closed
        if head[0].done:
            out, remaining[:] = list(remaining), []
            return out
        return ()                              # nothing yet, keep serving

    stats = eng.serve(head, source=source, max_batch=2)
    _assert_all_match(reqs, serial, "live submit")
    assert stats.steps_in_flight == 2
    assert all(r.t_enqueue >= head[0].t_done for r in tail)


def test_generator_source(minitron, serial):
    eng = _engine(minitron)
    reqs = _requests(serial)
    eng.serve(source=iter(reqs), max_batch=2)
    _assert_all_match(reqs, serial, "generator source")
    assert eng._src_thread is None
    assert not any(t.name == "engine-source-feeder" and t.is_alive()
                   for t in threading.enumerate())


def test_source_exception_relays_and_parks_pulled_requests(minitron):
    """The feeder relays a source's exception to the loop; requests it
    had pulled that the loop never served are parked in the engine
    queue, so a later drain() serves them."""
    cfg = minitron[0]
    rs = np.random.RandomState(5)

    def source():
        for _ in range(4):
            yield Request(prompt=rs.randint(0, cfg.vocab_size, 16)
                          .astype(np.int32), max_new_tokens=6)
        raise RuntimeError("upstream queue died")

    eng = _engine(minitron)
    with pytest.raises(RuntimeError, match="upstream queue died"):
        eng.serve(source=source(), max_batch=2)
    assert eng._src_thread is None             # the feeder was reaped
    parked = list(eng._queue)
    eng.drain(max_batch=2)
    assert not eng._queue, "drain must serve the parked requests"
    assert all(r.done and len(r.output) == 6 for r in parked)


def test_chunked_with_live_source(minitron, serial):
    eng = _engine(minitron, prefill_chunk=16)
    reqs = _requests(serial)
    head, tail = reqs[:2], reqs[2:]
    remaining = list(tail)

    def source():
        if not remaining:
            return None
        if head[0].done:
            out, remaining[:] = list(remaining), []
            return out
        return ()

    eng.serve(head, source=source, max_batch=2)
    _assert_all_match(reqs, serial, "chunked live source")


# ---------------------------------------------------------------------------
# preemption, recurrent state and chunked prefill under the async loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inflight", [1, 2])
def test_paged_preemption_async_resumes_byte_exact(minitron, inflight):
    """A pool that forces an eviction mid-flight: the victim's first
    token and in-flight emissions are read before it is requeued, so the
    resume (a re-prefill of prompt + output) stays byte-exact."""
    refs = _serial(minitron, (16, 16), (30, 30), seed=7)
    eng = _engine(minitron, paged=True, num_blocks=6, inflight=inflight)
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=2)
    assert stats.preemptions >= 1, "the pool should force an eviction"
    _assert_all_match(reqs, refs, f"preempted inflight={inflight}")
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


@pytest.mark.parametrize("paged", [False, True])
def test_async_rwkv6_matches_serial(paged):
    model = _model("rwkv6-1.6b")
    refs = _serial(model, (12, 19, 25), (8, 10, 6))
    eng = _engine(model, paged=paged)
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=2)
    _assert_all_match(reqs, refs, f"rwkv6 paged={paged}")
    assert stats.steps_in_flight == 2


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_async_matches_serial(minitron, serial, paged):
    eng = _engine(minitron, paged=paged, prefill_chunk=8)
    reqs = _requests(serial)
    stats = eng.serve(reqs, max_batch=3)
    _assert_all_match(reqs, serial, f"chunked paged={paged}")
    assert stats.prefill_chunks == sum(-(-n // 8) for n in LENS)
    assert stats.steps_in_flight == 2


@pytest.mark.parametrize("inflight", [1, 2])
def test_chunked_preemption_mid_prefill_async(minitron, inflight):
    refs = _serial(minitron, (64, 64), (10, 10), seed=7)
    eng = _engine(minitron, paged=True, num_blocks=8, prefill_chunk=16,
                  inflight=inflight)
    evicted = []
    preempt = eng._preempt

    def spy(si, slots, active, pending):
        evicted.append(si in eng._prefills)
        preempt(si, slots, active, pending)

    eng._preempt = spy
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=2)
    _assert_all_match(reqs, refs, f"mid-prefill preemption {inflight}")
    assert stats.preemptions >= 1 and any(evicted)
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


@pytest.mark.parametrize("inflight", [1, 2])
def test_active_victim_is_read_before_its_requeue(minitron, inflight):
    """Chunks that need blocks evict ACTIVE slots (two chunks a step, a
    pool of 7 blocks): a victim's first token and the emissions of the
    steps in flight that ran it are read before it is requeued, so its
    resume, which may rejoin in the same iteration, re-prefills all of
    its output and nothing twice."""
    refs = _serial(minitron, (30, 30, 60), (24, 10, 10), seed=7)
    eng = _engine(minitron, paged=True, num_blocks=8, prefill_chunk=16,
                  prefill_budget=32, inflight=inflight)
    active_victims = []
    preempt = eng._preempt

    def spy(si, slots, active, pending):
        active_victims.append(si not in eng._prefills)
        preempt(si, slots, active, pending)

    eng._preempt = spy
    reqs = _requests(refs)
    eng.serve(reqs, max_batch=2)
    _assert_all_match(reqs, refs, f"active victims inflight={inflight}")
    assert any(active_victims), "the pool should evict an active slot"
    assert eng._alloc.blocks_in_use == 0, "leaked blocks"


@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_request_done_at_its_first_token_async(minitron, serial, paged,
                                               inflight):
    """Budget 1: each final chunk's first token is read one step later,
    so each request rides one zombie step and the next one waits for the
    next iteration's budget (no pool deadlock), at either depth."""
    refs = [(p, 1, ref[:1]) for p, _, ref in serial[:3]]
    eng = _engine(minitron, paged=paged, prefill_chunk=32,
                  inflight=inflight)
    reqs = _requests(refs)
    stats = eng.serve(reqs, max_batch=1)
    _assert_all_match(reqs, refs, "first-token finish")
    assert stats.steps == 3 and stats.tokens == 0
    assert stats.prefill_chunks == 3


def test_dispatch_snapshots_are_copies():
    """An operand made from a mutable host array (the active mask, a
    block table) must not change when the host array does."""
    for arr in (np.zeros(12, np.int32), np.zeros(16, bool),
                np.zeros((2, 12), np.int32), np.zeros(3, bool)):
        snap = snapshot(arr, "cpu")
        arr[...] = 1
        assert not snap.any(), \
            f"snapshot of {arr.shape} {arr.dtype} aliased host memory"


def test_capture_step_never_engages_off_cuda(minitron, serial):
    outs = []
    for capture in (True, False):
        eng = _engine(minitron, paged=True, capture_step=capture)
        assert eng.capture_step is False
        reqs = _requests(serial)
        eng.serve(reqs, max_batch=3)
        assert eng.captured is None
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_one_pool_across_serve_calls(minitron, serial):
    """An engine keeps its pool (and, on CUDA, its capture) across serve
    calls with the same max_batch; each serve starts from a zeroed pool,
    so a second serve gives the first one's streams."""
    eng = _engine(minitron, paged=True)
    first = _requests(serial)
    eng.serve(first, max_batch=3)
    pool = eng._pool[1]
    again = _requests(serial)
    eng.serve(again[:3], source=iter(again[3:]), max_batch=3)
    assert eng._pool[1] is pool
    assert [r.output for r in again] == [r.output for r in first]
    eng.serve(_requests(serial)[:1], max_batch=2)
    assert eng._pool[0] == 2 and eng._pool[1] is not pool


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vicuna():
    """(jax cfg, port cfg, jax params, jax draft, port params, port
    draft, tree): vicuna-tiny in fp32, JAX-initialised."""
    jcfg, cfg = [dataclasses.replace(get("vicuna-tiny"), dtype="float32",
                                     vocab_size=VOCAB)
                 for get in (jax_get_config, get_config)]
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jdp = jax_init_draft(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    dp = bridge.draft_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
    return jcfg, cfg, jparams, jdp, params, dp, tree_for(cfg)


@pytest.mark.parametrize("case", ["dense", "paged-preempt", "chunked"])
def test_async_engine_matches_jax_engine(vicuna, case):
    jcfg, cfg, jparams, jdp, params, dp, tree = vicuna
    rs = np.random.RandomState(21)
    lens, budgets = (16, 23, 9, 40, 16), (12, 30, 10, 20, 30)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in lens]
    kw = dict(max_len=MAX_LEN, inflight=2)
    if case == "chunked":
        kw["prefill_chunk"] = 8
    if case == "paged-preempt":
        jeng = jax_engine.PagedSpeculativeEngine(
            jparams, jdp, jcfg, tree, block_size=BS, num_blocks=7, **kw)
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, block_size=BS,
                                     num_blocks=7, device="cpu", **kw)
    else:
        jeng = jax_engine.SpeculativeEngine(jparams, jdp, jcfg, tree, **kw)
        eng = SpeculativeEngine(params, dp, cfg, tree, device="cpu", **kw)
    jreqs = [jax_engine.Request(prompt=p.copy(), max_new_tokens=b)
             for p, b in zip(prompts, budgets)]
    reqs = [Request(prompt=p.copy(), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    jstats = jeng.serve(jreqs, max_batch=3)
    stats = eng.serve(reqs, max_batch=3)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert stats.steps == jstats.steps
    assert stats.steps_in_flight == jstats.steps_in_flight == 2
    assert stats.preemptions == jstats.preemptions
    assert (stats.prefill_chunks, stats.prefill_tokens) == (
        jstats.prefill_chunks, jstats.prefill_tokens)
    if case == "paged-preempt":
        assert stats.preemptions >= 1, "the pool should force an eviction"
        assert eng._alloc.blocks_in_use == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["--sync"], ["--stream"],
                                   ["--eager", "--stream"]])
def test_serve_launcher_loop_flags(capsys, flags):
    serve.main(["--arch", "minitron-4b", "--engine", "paged", "--batch", "2",
                "--requests", "3", "--prompt-len", "24", "--ragged",
                "--max-new-tokens", "24", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert "[serve] engine=paged " in out and "tokens=69 " in out
    peak = 1 if "--sync" in flags else 2
    assert f"inflight_peak={peak} " in out
