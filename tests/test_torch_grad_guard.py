"""Gradients through the port's kernels, and none where a kernel has no
backward.  No JAX here, so the gpu cases run on the card as they are.

* every kernel wrapper without a backward (K1, K2, K4, K5 and K3's
  chunk form) raises when grad mode is on and an operand requires a
  gradient, never returning a result detached from the graph, and runs
  the same call under ``torch.no_grad()``: on the CPU (the plain
  versions) and, gpu-marked, on the card (the kernels; no launch counted
  for a refused call);
* K3's whole prefill under autograd (``FlashAttention``): on the CPU its
  gradients equal autograd through ``blocked_attention`` on the same
  operands bitwise (the backward is that recomputation); gpu-marked, for
  each K3 build the card runs in training (causal, windowed,
  bidirectional, MLA's scale at (192, 128), fp32 and bf16 at head dims
  64, 80, 128 and 256), its output within K3's tolerance of the plain
  version (fp32 1e-4, bf16 2e-2) and its gradients, from the backward
  kernels (``csrc/flash_attention_bwd.cu``), each in its operand's dtype
  and within relative L2 1e-4 (fp32) or 5e-3 (bf16) of autograd through
  ``blocked_attention`` in fp32 on the same operands and output gradient;
  one launch counted in ``grad_launches`` and one call of the backward
  kernels in ``bwd_launches``;
* serving with params that require a gradient builds no graph:
  ``generate`` (Hydra++ heads), the engines and EAGLE's step return
  tensors with no gradient and leave no ``.grad`` anywhere.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core import eagle  # noqa: E402
from repro_torch.core.heads import init_draft_params  # noqa: E402
from repro_torch.core.speculative import generate  # noqa: E402
from repro_torch.kernels.attention_template.ops import \
    tree_attention_paged_windowed_bshd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k3  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import \
    flash_attention_plain  # noqa: E402
from repro_torch.kernels.mla_attention.ops import \
    mla_attention_paged_bshd  # noqa: E402
from repro_torch.kernels.tree_attention.dense_ops import \
    tree_attention_bshd  # noqa: E402
from repro_torch.kernels.tree_attention.ops import \
    tree_attention_paged_bshd  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        Request, SpeculativeEngine)
from repro_torch.training.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(2)
gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs an NVIDIA card (CUDA)")


def _wrapper_call(name: str, device: str, g: torch.Generator):
    """(call, operands that may require a gradient) for one wrapper, at
    shapes its kernel builds take (D=64; K5's latent 512 + rope 64)."""
    dev = torch.device(device)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)
    tm = torch.ones((4, 4), dtype=torch.bool).tril().to(dev)
    lens = torch.tensor([5, 20], dtype=torch.int32, device=dev)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    if name in ("K1", "K4"):
        q, tk, tv = rnd(2, 4, 2, 64), rnd(2, 4, 1, 64), rnd(2, 4, 1, 64)
        pk, pv = rnd(5, 16, 1, 64), rnd(5, 16, 1, 64)
        pos = lens[:, None].long() + torch.arange(4, device=dev)
        if name == "K1":
            return (lambda: tree_attention_paged_bshd(
                q, pk, pv, tk, tv, tm, lens, table)), (q, tk, tv)
        return (lambda: tree_attention_paged_windowed_bshd(
            q, pk, pv, tk, tv, tm, lens, table, pos, 8)), (q, tk, tv)
    if name == "K2":
        q, tk, tv = rnd(2, 4, 2, 64), rnd(2, 4, 1, 64), rnd(2, 4, 1, 64)
        ck, cv = rnd(2, 32, 1, 64), rnd(2, 32, 1, 64)
        return (lambda: tree_attention_bshd(q, ck, cv, tk, tv, tm, lens)), \
            (q, tk, tv)
    if name == "K5":
        ql, qr = rnd(2, 4, 2, 512), rnd(2, 4, 2, 64)
        pl, pr = rnd(5, 16, 512), rnd(5, 16, 64)
        tl, tr = rnd(2, 4, 512), rnd(2, 4, 64)
        return (lambda: mla_attention_paged_bshd(
            ql, qr, pl, pr, tl, tr, tm, lens, table,
            scale=1 / math.sqrt(192))), (ql, tl)
    assert name == "K3 chunk"
    q, k, v = rnd(1, 16, 2, 64), rnd(1, 64, 1, 64), rnd(1, 64, 1, 64)
    return (lambda: k3.flash_attention_bshd(q, k, v, q_off=16,
                                            kv_valid_len=32)), (q, k, v)


WRAPPERS = ["K1", "K2", "K4", "K5", "K3 chunk"]


def _guarded(name: str, device: str):
    call, ops = _wrapper_call(name, device, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = call()                          # runs without a gradient
    kernels.reset_counts()
    for t in ops:
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    assert all(v == 0 for v in kernels.launch_counts().values())
    with torch.no_grad():                     # and again without
        out = call()
    first = ref[0] if isinstance(ref, tuple) else ref
    again = out[0] if isinstance(out, tuple) else out
    assert not again.requires_grad and torch.equal(first, again)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_without_backward_refuse_grad(name):
    _guarded(name, "cpu")


@gpu
@needs_cuda
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_without_backward_refuse_grad_on_the_card(name):
    _guarded(name, "cuda")


# ---------------------------------------------------------------------------
# K3 under autograd
# ---------------------------------------------------------------------------

# (name, dtype, Hq, Hkv, Dqk, Dv, S, causal, window, scale)
K3_CASES = [
    ("causal fp32 D64", torch.float32, 4, 4, 64, 64, 96, True, 0, None),
    ("windowed fp32 D256", torch.float32, 4, 1, 256, 256, 80, True, 16,
     None),
    ("bidirectional fp32 D80", torch.float32, 4, 4, 80, 80, 70, False, 0,
     None),
    ("mla fp32 192/128", torch.float32, 2, 2, 192, 128, 64, True, 0,
     1 / math.sqrt(192)),
    ("causal fp32 D128 GQA", torch.float32, 6, 2, 128, 128, 100, True, 0,
     None),
    ("causal bf16 D64", torch.bfloat16, 4, 4, 64, 64, 96, True, 0, None),
    ("bidirectional bf16 D80", torch.bfloat16, 4, 4, 80, 80, 130, False, 0,
     None),
    ("causal bf16 D128", torch.bfloat16, 6, 2, 128, 128, 200, True, 0,
     None),
    ("windowed bf16 D256", torch.bfloat16, 4, 1, 256, 256, 300, True, 64,
     None),
    ("mla bf16 192/128", torch.bfloat16, 4, 4, 192, 128, 150, True, 0,
     1 / math.sqrt(192)),
]


def _k3_operands(case, device):
    _, dtype, hq, hkv, dqk, dv, S, causal, window, scale = case
    g = torch.Generator().manual_seed(S)
    mk = lambda *s: torch.randn(s, generator=g).to(device=device,
                                                   dtype=dtype)
    q, k, v = mk(2, S, hq, dqk), mk(2, S, hkv, dqk), mk(2, S, hkv, dv)
    w = torch.randn((2, S, hq, dv), generator=g).to(device=device,
                                                    dtype=dtype)
    return (q, k, v, w), dict(causal=causal, window=window, scale=scale)


def _grads(fn, q, k, v, w, kw):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, **kw)
    loss = (out.float() * w.float()).sum()
    return out.detach(), torch.autograd.grad(loss, leaves)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _check_k3(case, device):
    (q, k, v, w), kw = _k3_operands(case, device)
    kernels.reset_counts()
    out, grads = _grads(k3.flash_attention_bshd, q, k, v, w, kw)
    if device == "cuda":
        assert (k3.launches, k3.grad_launches, k3.bwd_launches) == (1,) * 3
        ref, ref_grads = _grads(flash_attention_plain, q.float(), k.float(),
                                v.float(), w, kw)
        tol = 1e-4 if q.dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        bound = 1e-4 if q.dtype == torch.float32 else 5e-3
        for a, b, t, what in zip(grads, ref_grads, (q, k, v), "qkv"):
            assert a.dtype == t.dtype and torch.isfinite(a).all(), what
            assert _rel_l2(a, b) <= bound, f"{case[0]}: d{what} differs"
        return
    ref, ref_grads = _grads(flash_attention_plain, q, k, v, w, kw)
    assert (k3.launches, k3.grad_launches) == (0, 0)
    assert torch.equal(out, ref)
    for a, b, what in zip(grads, ref_grads, "qkv"):
        assert a.dtype == b.dtype and torch.equal(a, b), \
            f"{case[0]}: d{what} differs"


@pytest.mark.parametrize("case", [c for c in K3_CASES
                                  if c[1] == torch.float32],
                         ids=lambda c: c[0])
def test_k3_autograd_equals_blocked_attention(case):
    _check_k3(case, "cpu")


@gpu
@needs_cuda
@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: c[0])
def test_k3_autograd_on_the_card(case):
    torch.backends.cuda.matmul.allow_tf32 = False
    _check_k3(case, "cuda")


# ---------------------------------------------------------------------------
# serving stays grad-free
# ---------------------------------------------------------------------------


def _all_require_grad(*trees):
    for t in trees:
        for p in tree_leaves(t):
            p.requires_grad_(True)


def _no_grad_anywhere(*trees):
    return all(p.grad is None for t in trees for p in tree_leaves(t))


def test_serving_with_trainable_params_builds_no_graph():
    cfg = dataclasses.replace(get_config("minitron-4b").reduced(),
                              dtype="float32", vocab_size=16)
    params = init_params(cfg, seed=0, device="cpu")
    dp = init_draft_params(cfg, seed=1, device="cpu")
    ep = eagle.init_eagle_params(cfg, seed=2, device="cpu")
    _all_require_grad(params, dp, ep)
    assert torch.is_grad_enabled()
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 16, (2, 12))).long()
    toks, _, acc = generate(params, dp, cfg, tree_for(cfg), prompt,
                            max_new_tokens=8, max_len=64)
    assert not toks.requires_grad and not acc.requires_grad
    st = eagle.init_eagle_decode_state(params, ep, cfg, prompt, 64)
    res = eagle.eagle_spec_step(params, ep, cfg, 4, st)
    for x in (res.emitted, res.n_emitted, res.state.last_hidden,
              res.state.prefix_k,
              *res.state.cache[0].values()):
        assert not x.requires_grad and x.grad_fn is None
    for eng in (SpeculativeEngine(params, dp, cfg, tree_for(cfg), max_len=64,
                                  device="cpu"),
                PagedSpeculativeEngine(params, dp, cfg, tree_for(cfg),
                                       max_len=64, device="cpu")):
        reqs = [Request(prompt=p.numpy(), max_new_tokens=6) for p in prompt]
        eng.serve(reqs, max_batch=2)
        assert all(len(r.output) >= 6 for r in reqs)
    assert _no_grad_anywhere(params, dp, ep)
