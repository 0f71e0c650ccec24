"""The port's engines under Hydra and Medusa heads, and without
speculation, against JAX serial ``generate()`` (greedy, exact), at
``minitron-4b.reduced()`` in fp32 with a 16-token vocabulary (so random
heads get candidates accepted and the commit moves entries).

``tests/test_torch_engine.py`` holds the engines under Hydra++; here, per
head kind (Hydra, Medusa) and for ``use_speculative=False``, a ragged
workload of six requests over four slots goes through:

* the dense engine at ``inflight`` 1, 2 and 3;
* the paged engine at block sizes 8, 16 and 32, each at ``inflight`` 1,
  2 and 3, over small pools; at each block size the speculative runs
  preempt at ``inflight=1`` (and at 8 also at 2); elsewhere whether a pool
  preempts or queues depends on the heads' acceptance (the stale
  allowance keeps a joiner out), so only parity is asserted there;
* the chunked engine (paged, chunks of 16) at ``inflight`` 1, 2 and 3;
* the bucketed engine;

and every request's stream must equal JAX serial ``generate()``'s, with
no block left in use.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN  # noqa: E402
from repro_torch.serving.engine import (BucketedEngine,  # noqa: E402
                                        PagedSpeculativeEngine, Request,
                                        SpeculativeEngine)

torch.set_num_threads(2)
VOCAB = 16
MAX_LEN = 128
LENS = (16, 23, 32, 9, 40, 12)
BUDGETS = (12, 14, 8, 10, 13, 9)
# what the engines decode: a head kind (speculative) or none (autoregressive)
KINDS = {"hydra": dict(kind="hydra", n_mlp_layers=1, prefix_attention=False),
         "medusa": dict(kind="medusa", n_mlp_layers=1,
                        prefix_attention=False),
         "autoregressive": None}
# paged: (block size, inflight) -> (usable blocks + NULL, preempts under
# speculation)
PAGED = {(8, 1): (10, True), (8, 2): (11, True), (8, 3): (13, False),
         (16, 1): (6, True), (16, 2): (6, False), (16, 3): (8, False),
         (32, 1): (4, True), (32, 2): (4, False), (32, 3): (5, False)}
ENGINES = (["dense@1", "dense@2", "dense@3"]
           + [f"paged{bs}@{i}" for bs, i in PAGED]
           + ["chunked@1", "chunked@2", "chunked@3", "bucketed"])


def _cfgs(kind: str):
    draft = KINDS[kind] or KINDS["hydra"]
    out = []
    for get in (jax_get_config, get_config):
        c = get("minitron-4b").reduced()
        out.append(dataclasses.replace(
            c, dtype="float32", vocab_size=VOCAB,
            draft=dataclasses.replace(c.draft, **draft)))
    return out


def _stream(toks):
    return [int(t) for t in np.asarray(toks)[0] if t != PAD_TOKEN]


@pytest.fixture(scope="module")
def refs():
    """Per kind: the port's (cfg, params, draft params, tree) and JAX
    serial ``generate()`` of each request."""
    jparams = params = None
    out = {}
    rs = np.random.default_rng(4)
    prompts = [rs.integers(0, VOCAB, n).astype(np.int32) for n in LENS]
    for i, kind in enumerate(KINDS):
        jcfg, cfg = _cfgs(kind)
        if jparams is None:
            jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
            params = bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
        jdp = jax_init_draft(jax.random.PRNGKey(20 + i), jcfg)
        dp = bridge.draft_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jdp), cfg, "cpu")
        tree = tree_for(cfg)
        spec = KINDS[kind] is not None
        streams = [_stream(jax_generate(
            jparams, jdp, jcfg, tree, jnp.asarray(p)[None],
            max_new_tokens=b, max_len=MAX_LEN, use_speculative=spec)[0])[:b]
            for p, b in zip(prompts, BUDGETS)]
        out[kind] = (cfg, params, dp, tree, spec, prompts, streams)
    return out


def _engine(ref, name: str):
    cfg, params, dp, tree, spec, _, _ = ref
    kw = dict(max_len=MAX_LEN, use_speculative=spec, device="cpu")
    if name == "bucketed":
        return BucketedEngine(params, dp, cfg, tree, **kw), False
    layout, inflight = name.split("@")
    kw["inflight"] = int(inflight)
    if layout == "dense":
        return SpeculativeEngine(params, dp, cfg, tree, **kw), False
    if layout == "chunked":
        return PagedSpeculativeEngine(params, dp, cfg, tree, block_size=16,
                                      prefill_chunk=16, **kw), False
    bs = int(layout[len("paged"):])
    num_blocks, preempts = PAGED[bs, int(inflight)]
    return (PagedSpeculativeEngine(params, dp, cfg, tree, block_size=bs,
                                   num_blocks=num_blocks, **kw),
            preempts and spec)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_engine_equals_jax_serial_generate(refs, kind, engine):
    ref = refs[kind]
    eng, preempts = _engine(ref, engine)
    reqs = [Request(prompt=p.copy(), max_new_tokens=b)
            for p, b in zip(ref[5], BUDGETS)]
    stats = eng.serve(reqs, max_batch=4)
    for r, want in zip(reqs, ref[6]):
        assert r.done and r.output == want
    if isinstance(eng, PagedSpeculativeEngine):
        assert eng._alloc.blocks_in_use == 0
    if preempts:
        assert stats.preemptions >= 1
    if ref[4]:
        assert stats.tokens_per_step > 1.0, "no candidate was accepted"
