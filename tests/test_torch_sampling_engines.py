"""Sampled decoding through the port's ``generate()`` and its engines, at
``vicuna-tiny``, ``rwkv6-1.6b.reduced()`` and ``zamba2-1.2b.reduced()``
(fp32, the port's own random weights; no JAX: across frameworks only the
injected-noise cases of ``tests/test_torch_sampling.py`` can match).

* ``generate(criterion="typical")`` (typical acceptance; its first token
  drawn at temperature 1) and sampled autoregressive decoding
  (``use_speculative=False``): the same seed gives the same streams, and
  another seed other streams;
* at ``max_batch=1`` the requests are served one after another, so every
  engine issues the draws serial ``generate()`` issues, in the same order
  and shapes: the dense engine at ``inflight`` 1, 2 and 3, the paged one
  at 1, 2 and 3, the chunked one and the bucketed one equal the port's
  serial ``generate()`` (one generator, seeded as the engine, carried from
  request to request) token for token;
* an engine serving four requests at once repeats its streams under the
  same seed, and so does one whose pool preempts (a preempted request
  re-prefills and draws afresh);
* greedy draws nothing: a greedy engine leaves its generator untouched;
* ``gpu``-marked, on the card: three replays of a sampling step captured
  as a CUDA graph, each bitwise equal to the eager step from the same
  state and generator state, each moving the generator on; a captured
  sampled serve gives the eager serve's streams under the same seed.
  Run there with
  ``python -m pytest --noconftest -m gpu tests/test_torch_sampling_engines.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.heads import init_draft_params  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import (BucketedEngine,  # noqa: E402
                                        PagedSpeculativeEngine, Request,
                                        SpeculativeEngine)

torch.set_num_threads(2)
ARCHS = {"vicuna-tiny": lambda: get_config("vicuna-tiny"),
         "rwkv6-1.6b": lambda: get_config("rwkv6-1.6b").reduced(),
         "zamba2-1.2b": lambda: get_config("zamba2-1.2b").reduced()}
MAX_LEN = 128
SEED = 5
LENS = (9, 14, 21)            # ascending: the bucketed engine's order too
BUDGET = 12
SPEC = {"typical": True, "sampled AR": False}


@pytest.fixture(scope="module")
def models():
    out = {}

    def get(arch):
        if arch not in out:
            cfg = dataclasses.replace(ARCHS[arch](), dtype="float32")
            params = init_params(cfg, seed=0, device="cpu")
            dp = init_draft_params(cfg, seed=1, device="cpu")
            rs = np.random.default_rng(3)
            prompts = [rs.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in LENS]
            out[arch] = (cfg, params, dp, tree_for(cfg), prompts, {})
        return out[arch]
    return get


def _stream(toks):
    return [int(t) for t in np.asarray(toks)[0] if t != PAD_TOKEN]


def _serial(model, spec: bool, seed: int = SEED):
    """Serial ``generate()`` of each prompt in turn from one generator."""
    cfg, params, dp, tree, prompts, cache = model
    if (spec, seed) not in cache:
        gen = torch.Generator().manual_seed(seed)
        cache[spec, seed] = [
            _stream(generate(params, dp, cfg, tree,
                             torch.from_numpy(p)[None].long(),
                             max_new_tokens=BUDGET, max_len=MAX_LEN,
                             use_speculative=spec, criterion="typical",
                             generator=gen)[0])[:BUDGET]
            for p in prompts]
    return cache[spec, seed]


@pytest.mark.parametrize("spec", list(SPEC))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_generate_same_seed_same_streams(models, arch, spec):
    model = models(arch)
    cfg, params, dp, tree, prompts, _ = model
    first = _serial(model, SPEC[spec])
    gen = torch.Generator().manual_seed(SEED)
    redo = [_stream(generate(params, dp, cfg, tree,
                             torch.from_numpy(p)[None].long(),
                             max_new_tokens=BUDGET, max_len=MAX_LEN,
                             use_speculative=SPEC[spec], criterion="typical",
                             generator=gen)[0])[:BUDGET] for p in prompts]
    assert redo == first
    assert all(len(s) == BUDGET for s in first)
    assert all(0 <= t < cfg.vocab_size for s in first for t in s)
    assert _serial(model, SPEC[spec], seed=SEED + 1) != first


MODES = {
    "dense@1": (SpeculativeEngine, dict(inflight=1)),
    "dense@2": (SpeculativeEngine, dict(inflight=2)),
    "dense@3": (SpeculativeEngine, dict(inflight=3)),
    "paged@1": (PagedSpeculativeEngine, dict(inflight=1, block_size=8)),
    "paged@2": (PagedSpeculativeEngine, dict(inflight=2, block_size=16)),
    "paged@3": (PagedSpeculativeEngine, dict(inflight=3, block_size=32)),
    "chunked@2": (PagedSpeculativeEngine, dict(inflight=2,
                                               prefill_chunk=16)),
    "bucketed": (BucketedEngine, {}),
}


def _engine(model, mode: str, spec: bool, seed: int = SEED):
    cfg, params, dp, tree, _, _ = model
    cls, kw = MODES[mode]
    return cls(params, dp, cfg, tree, max_len=MAX_LEN, use_speculative=spec,
               criterion="typical", seed=seed, device="cpu", **kw)


def _requests(model):
    return [Request(prompt=p.copy(), max_new_tokens=BUDGET)
            for p in model[4]]


@pytest.mark.parametrize("spec", list(SPEC))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_one_slot_equals_serial_generate(models, arch, mode, spec):
    model = models(arch)
    eng = _engine(model, mode, SPEC[spec])
    reqs = _requests(model)
    stats = eng.serve(reqs, max_batch=1)
    assert [r.output for r in reqs] == _serial(model, SPEC[spec])
    if SPEC[spec]:       # random weights, flat distributions: deep paths
        assert stats.tokens_per_step > 2.0
    if isinstance(eng, PagedSpeculativeEngine):
        assert eng._alloc.blocks_in_use == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_same_seed_same_streams(models, arch):
    """Four requests over two slots: the schedule is the host's and
    deterministic, so the same seed repeats every stream."""
    model = models(arch)
    reqs = [Request(prompt=p.copy(), max_new_tokens=BUDGET)
            for p in model[4] * 2]
    outs = []
    for _ in range(2):
        rs = [dataclasses.replace(r, output=[]) for r in reqs]
        _engine(model, "paged@2", True).serve(rs, max_batch=2)
        outs.append([r.output for r in rs])
    assert outs[0] == outs[1]
    assert all(len(o) == BUDGET for o in outs[0])


@pytest.mark.parametrize("arch", ["vicuna-tiny", "rwkv6-1.6b"])
def test_sampled_preemption(models, arch):
    """A pool too small for two slots preempts; the requeued request
    re-prefills and draws afresh, every request completes, no block stays
    in use, and the same seed repeats the whole schedule's streams."""
    model = models(arch)
    cfg, params, dp, tree, prompts, _ = model
    outs = []
    for _ in range(2):
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                     block_size=8, num_blocks=12, inflight=1,
                                     criterion="typical", seed=SEED,
                                     device="cpu")
        reqs = [Request(prompt=p.copy(), max_new_tokens=30)
                for p in prompts * 2]
        stats = eng.serve(reqs, max_batch=2)
        assert stats.preemptions >= 1
        assert all(r.done and len(r.output) == 30 for r in reqs)
        assert eng._alloc.blocks_in_use == 0
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_greedy_engine_draws_nothing(models):
    cfg, params, dp, tree, prompts, _ = models("vicuna-tiny")
    eng = SpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                            seed=SEED, device="cpu")
    before = eng.generator.get_state()
    eng.serve([Request(prompt=p.copy(), max_new_tokens=BUDGET)
               for p in prompts], max_batch=2)
    assert torch.equal(eng.generator.get_state(), before)


def test_unknown_criterion_raises(models):
    cfg, params, dp, tree, _, _ = models("vicuna-tiny")
    with pytest.raises(ValueError, match="criterion"):
        SpeculativeEngine(params, dp, cfg, tree, criterion="rejection",
                          device="cpu")
    with pytest.raises(ValueError, match="criterion"):
        generate(params, dp, cfg, tree, torch.zeros((1, 4), dtype=torch.long),
                 max_new_tokens=2, criterion="nucleus")


# ---------------------------------------------------------------------------
# on the card: the captured step draws from the engine's CUDA generator
# ---------------------------------------------------------------------------


def _cuda_model(arch: str):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=16,
                              dtype="float32")
    return (cfg, init_params(cfg, seed=0, device="cuda"),
            init_draft_params(cfg, seed=1, device="cuda"), tree_for(cfg))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("spec", list(SPEC))
@pytest.mark.parametrize("arch", ["minitron-4b", "rwkv6-1.6b"])
def test_cuda_sampled_replay_equals_eager_step(arch, spec):
    """Three replays, each bitwise equal to the eager step from the same
    state and the same generator state; each replay moves the generator
    on, and the capture leaves it where it was."""
    from repro_torch.serving.graph import CapturedStep, step_in_place
    cfg, params, dp, tree = _cuda_model(arch)
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 use_speculative=SPEC[spec],
                                 criterion="typical", capture_step=False)
    B = 4
    eng._init_pool(B)
    eng._seq, eng._join_seq = 0, np.zeros(B, np.int64)   # serve() sets
    state = eng._pool[1]
    rs = np.random.RandomState(3)
    for si in range(B):
        r = Request(prompt=rs.randint(0, 16, 9 + 7 * si).astype(np.int32))
        eng._join(state, si, r)
    gen = eng.generator
    before = gen.get_state()
    cap = CapturedStep(eng._step, state, B, eng._tables.shape, generator=gen)
    assert torch.equal(gen.get_state(), before)
    eager = _clone(state)
    active = np.array([True, True, False, True])
    table = torch.as_tensor(eng._tables, device="cuda")
    for k in range(3):
        rng = gen.get_state()
        e1, n1 = (t.clone() for t in cap(active, eng._tables))
        after = gen.get_state()
        assert not torch.equal(after, rng), "a replay drew nothing"
        gen.set_state(rng)
        e2, n2 = step_in_place(eng._step, eager,
                               torch.as_tensor(active, device="cuda"), table)
        torch.cuda.synchronize()
        assert torch.equal(gen.get_state(), after)
        for name, a, b in (("emitted", e1, e2), ("n_emitted", n1, n2),
                           ("cache_len", state.cache_len, eager.cache_len),
                           ("last_token", state.last_token, eager.last_token),
                           ("last_hidden", state.last_hidden,
                            eager.last_hidden)):
            assert torch.equal(a, b), f"{arch} step {k}: {name} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-1.2b"])
def test_cuda_captured_sampled_serve_equals_eager_serve(arch):
    cfg, params, dp, tree = _cuda_model(arch)
    outs = []
    for capture in (True, False):
        eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                     criterion="typical", seed=SEED,
                                     capture_step=capture)
        rs = np.random.RandomState(0)
        reqs = [Request(prompt=rs.randint(0, 16, n).astype(np.int32),
                        max_new_tokens=20) for n in (16, 23, 9, 40, 12)]
        eng.serve(reqs, max_batch=2)
        assert (eng.captured is not None) == capture
        outs.append([r.output for r in reqs])
        assert eng._alloc.blocks_in_use == 0
    assert outs[0] == outs[1]
