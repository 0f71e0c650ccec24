"""The decode step captured as one CUDA graph (``serving/graph.py``).

On the card (``gpu``-marked; they skip without one), for each reduced
family (minitron-4b, a gemma3-1b whose 16-token window binds,
deepseek-v2-lite-16b, rwkv6-1.6b, zamba2-1.2b; fp32 with TF32 off, as
phase 4 of ``chip_smoke.py`` runs them (K3's bf16 builds do not take the
reduced MLA widths), a 16-token vocabulary so candidates get accepted):

* a replayed step and an eager step from the same state give bitwise
  equal ``emitted``, ``n_emitted``, ``cache_len``, ``last_token`` and
  ``last_hidden``, step after step, paged and dense;
* a whole serve through the captured engine gives the eager engine's
  streams and step count (and so does the dense engine at minitron);
* one capture serves every ``serve`` call, a generator source included,
  and replays count the steps;
* a capture launches what one eager step launches (the launch counters
  count at capture);
* a step that waits on the host inside the capture raises, and the
  engine does not fall back to the eager step.

    python -m pytest --noconftest -m gpu tests/test_torch_graph_step.py

On the CPU: ``CapturedStep`` refuses a CPU state, and ``step_in_place``
leaves the state as the functional step's result.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.heads import init_draft_params  # noqa: E402
from repro_torch.core.speculative import (init_pool_state,  # noqa: E402
                                          join_slot, spec_decode_step)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request, SpeculativeEngine)
from repro_torch.serving.graph import CapturedStep, step_in_place  # noqa: E402
from repro_torch.serving.paged import (init_paged_state,  # noqa: E402
                                       paged_join_slot,
                                       paged_spec_decode_step)

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"
VOCAB = 16
MAX_LEN = 128
BS = 16
B = 4
LENS = (17, 30, 9, 40)
FAMILIES = {
    "minitron-4b": {},
    "gemma3-1b": {"window_pattern": (16, 0)},
    "deepseek-v2-lite-16b": {},
    "rwkv6-1.6b": {},
    "zamba2-1.2b": {},
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _model(arch, device="cuda"):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=VOCAB,
                              dtype="float32", **FAMILIES[arch])
    return (cfg, init_params(cfg, seed=0, device=device),
            init_draft_params(cfg, seed=1, device=device), tree_for(cfg))


def _joined(model, paged: bool, device="cuda"):
    """A pool of B slots with a prompt joined into each, and the step over
    it: (state, step(state, active, table), host table or None)."""
    cfg, params, dp, tree = model
    rs = np.random.RandomState(3)
    M = MAX_LEN // BS
    table = None
    if paged:
        table = (1 + np.arange(B * M, dtype=np.int32)).reshape(B, M)
        state = init_paged_state(params, dp, cfg, B, 1 + B * M, BS, device)
    else:
        state = init_pool_state(params, dp, cfg, B, MAX_LEN, device)
    for si, n in enumerate(LENS):
        prompt = torch.as_tensor(rs.randint(0, VOCAB, 48), device=device)
        if paged:
            paged_join_slot(params, dp, cfg, state, prompt, n, si,
                            torch.as_tensor(table[si], device=device))
        else:
            join_slot(params, dp, cfg, state, prompt, n, si)

    def step(st, active, tbl):
        if paged:
            return paged_spec_decode_step(params, dp, cfg, tree, st, tbl,
                                          active=active)
        return spec_decode_step(params, dp, cfg, tree, st, active=active)
    return state, step, table


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


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_replay_equals_eager_step(arch, paged):
    _cuda()
    state, step, table = _joined(_model(arch), paged)
    eager = _clone(state)
    cap = CapturedStep(step, state, B, None if table is None
                       else table.shape)
    active = np.array([True, True, False, True])
    dev_table = None if table is None else torch.as_tensor(table,
                                                           device="cuda")
    for k in range(3):
        e1, n1 = (t.clone() for t in cap(active, table))
        e2, n2 = step_in_place(step, eager,
                               torch.as_tensor(active, device="cuda"),
                               dev_table)
        torch.cuda.synchronize()
        for name, a, b in (("emitted", e1, e2), ("n_emitted", n1, n2),
                           ("cache_len", state.cache_len, eager.cache_len),
                           ("last_token", state.last_token, eager.last_token),
                           ("last_hidden", state.last_hidden,
                            eager.last_hidden)):
            assert torch.equal(a, b), f"{arch} step {k}: {name} differs"
    assert cap.replays == 3


def _serve(model, engine, capture: bool, reqs_from, **kw):
    cfg, params, dp, tree = model
    cls = PagedSpeculativeEngine if engine == "paged" else SpeculativeEngine
    extra = dict(block_size=BS, num_blocks=24) if engine == "paged" else {}
    eng = cls(params, dp, cfg, tree, max_len=MAX_LEN, capture_step=capture,
              **extra, **kw)
    reqs = reqs_from()
    stats = eng.serve(reqs, max_batch=B)
    return eng, [r.output for r in reqs], stats


def _requests(seed=0):
    rs = np.random.RandomState(seed)
    return [Request(prompt=rs.randint(0, VOCAB, n).astype(np.int32),
                    max_new_tokens=b)
            for n, b in zip((16, 23, 32, 9, 40, 12), (30, 26, 30, 22, 30, 20))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,engine", [(a, "paged") for a in FAMILIES]
                         + [("minitron-4b", "continuous")])
def test_captured_serve_equals_eager_serve(arch, engine):
    _cuda()
    model = _model(arch)
    eng, outs, stats = _serve(model, engine, True, _requests)
    _, eager_outs, eager_stats = _serve(model, engine, False, _requests)
    assert eng.captured is not None
    assert outs == eager_outs
    assert stats.steps == eager_stats.steps
    assert eng.captured.replays == stats.steps + stats.warmup_steps
    if engine == "paged":
        assert eng._alloc.blocks_in_use == 0, "leaked blocks"


@pytest.mark.gpu
def test_one_capture_across_serves():
    _cuda()
    model = _model("gemma3-1b")
    cfg, params, dp, tree = model
    eng = PagedSpeculativeEngine(params, dp, cfg, tree, max_len=MAX_LEN,
                                 block_size=BS, num_blocks=24)
    first = _requests()
    eng.serve(first, max_batch=B)
    cap = eng.captured
    again = _requests()
    stats = eng.serve(again[:2], source=iter(again[2:]), max_batch=B)
    assert eng.captured is cap
    assert [r.output for r in again] == [r.output for r in first]
    assert cap.replays == stats.steps + stats.warmup_steps
    assert eng._alloc.blocks_in_use == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launches_per_capture_equal_an_eager_step(arch):
    _cuda()
    state, step, table = _joined(_model(arch), True)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    kernels.reset_counts()
    step_in_place(step, _clone(state), active,
                  torch.as_tensor(table, device="cuda"))
    eager = kernels.launch_counts()
    cap = CapturedStep(step, state, B, table.shape)
    assert cap.launches == eager
    if arch != "rwkv6-1.6b":
        assert sum(cap.launches.values()) > 0
    else:
        assert sum(cap.launches.values()) == 0   # rwkv6's step: no kernel
    before = kernels.launch_counts()
    cap(np.ones(B, bool), table)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before     # replays count apart


@pytest.mark.gpu
def test_capture_with_a_host_sync_raises():
    """A step that reads a value back inside the capture raises; the
    engine surfaces it instead of running the step eagerly.  In a child
    process: a failed capture leaves the CUDA context to be torn down."""
    _cuda()
    code = textwrap.dedent("""
        import dataclasses
        import numpy as np
        import torch
        from repro_torch.configs import get_config, tree_for
        from repro_torch.core.heads import init_draft_params
        from repro_torch.models.model import init_params
        from repro_torch.serving.engine import (PagedSpeculativeEngine,
                                                Request)

        class Syncing(PagedSpeculativeEngine):
            def _step(self, state, active, table=None):
                res = super()._step(state, active, table)
                int(res.n_emitted.sum())        # a host read: no capture
                return res

        cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                                  vocab_size=16, dtype="float32")
        eng = Syncing(init_params(cfg, seed=0, device="cuda"),
                      init_draft_params(cfg, seed=1, device="cuda"), cfg,
                      tree_for(cfg), max_len=128, block_size=16)
        try:
            eng.serve([Request(prompt=np.zeros(8, np.int32),
                               max_new_tokens=4)], max_batch=2)
        except RuntimeError as e:
            print("RAISED", type(e).__name__, e)
            raise SystemExit(3)
        print("NO RAISE", eng.captured)
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    run = subprocess.run([sys.executable, "-c", code], env=env, timeout=600,
                         capture_output=True, text=True)
    assert run.returncode == 3, run.stdout + run.stderr
    assert "RAISED" in run.stdout and "captur" in run.stdout.lower(), \
        run.stdout


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_captured_step_refuses_a_cpu_state():
    state, step, table = _joined(_model("minitron-4b", "cpu"), True, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(step, state, B, table.shape)


@pytest.mark.parametrize("arch", ["minitron-4b", "rwkv6-1.6b",
                                  "zamba2-1.2b"])
def test_step_in_place_equals_the_functional_step(arch):
    """The in-place step (the captured body) leaves in the state's own
    tensors what the functional step returns, and keeps the caches the
    state's own objects."""
    state, step, table = _joined(_model(arch, "cpu"), True, "cpu")
    ref_state = _clone(state)
    active = torch.tensor([True, True, False, True])
    t = torch.as_tensor(table)
    ref = step(ref_state, active, t)
    ids = [id(x) for x in (state.cache_len, state.last_token,
                           state.last_hidden)]
    emitted, n_emitted = step_in_place(step, state, active, t)
    assert torch.equal(emitted, ref.emitted)
    assert torch.equal(n_emitted, ref.n_emitted)
    for name in ("cache_len", "last_token", "last_hidden"):
        assert torch.equal(getattr(state, name), getattr(ref.state, name))
    assert ids == [id(x) for x in (state.cache_len, state.last_token,
                                   state.last_hidden)]


@pytest.mark.parametrize("tail", [(), (2, 4), (6,)])
def test_dense_scatter_drops_writes_past_the_end(tail):
    """The dense verify's scratch write (no boolean mask, so it can be
    captured) equals the masked scatter it replaced: rows whose scratch
    runs past the cache drop those writes, a row at or past the end
    writes nothing."""
    from repro_torch.models.attention import _dense_scatter

    g = torch.Generator().manual_seed(0)
    B, S, T = 4, 10, 4
    cache = torch.randn((B, S, *tail), generator=g)
    new = torch.randn((B, T, *tail), generator=g)
    cache_len = torch.tensor([2, 8, 10, 7], dtype=torch.int32)
    want = cache.clone()
    for b in range(B):
        for t in range(T):
            if cache_len[b] + t < S:
                want[b, cache_len[b] + t] = new[b, t]
    _dense_scatter(cache, new, cache_len)
    assert torch.equal(cache, want)
