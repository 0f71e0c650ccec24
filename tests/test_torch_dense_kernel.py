"""The port's dense tree-verify attention (K2) against the JAX reference.

On the CPU the port's wrapper ``tree_attention_bshd`` runs the kernel's
plain version (the tree K/V written into a copy of the cache, then
``masked_attention`` under the verify mask); these tests hold it against
the JAX Pallas kernel (``tree_attention_bshd``, dense layout, interpret
mode) and the JAX oracle ``tree_attention_ref`` on ragged lengths, GQA
grouping, T padding (T = 13 and 5 padded to 16 and 8) and an empty slot,
at ``atol = rtol = 2e-5`` (fp32, the two sides sum in different orders).
Positions at or past ``cache_len`` hold garbage the result never sees.
The dense verify branch of ``gqa_fwd`` goes through the wrapper at window
0 and keeps ``masked_attention`` for a sliding-window layer.  The CUDA
kernel against the plain version is the ``gpu``-marked case; it skips
without a card.  The JAX side is imported inside the helper that runs it:

    python -m pytest --noconftest -m gpu tests/test_torch_dense_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.tree_attention import dense_ops  # noqa: E402
from repro_torch.kernels.tree_attention.kernel import (  # noqa: E402
    tree_attention_dense_plain)
from repro_torch.models import attention  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, B, T, Hq, Hkv, D, S, lens, fill=None):
    """Random fp32 inputs in the MODEL layout; with ``fill``, every cache
    position at or past cache_len holds it."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    c = dict(q=r(B, T, Hq, D), ck=r(B, S, Hkv, D), cv=r(B, S, Hkv, D),
             tk=r(B, T, Hkv, D), tv=r(B, T, Hkv, D))
    if fill is not None:
        for b, n in enumerate(lens):
            c["ck"][b, n:] = fill
            c["cv"][b, n:] = fill
    return c


def _port(c, tm, lens):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return dense_ops.tree_attention_bshd(
        t["q"], t["ck"], t["cv"], t["tk"], t["tv"], torch.from_numpy(tm),
        torch.tensor(lens, dtype=torch.int32)).numpy()


def _jax(name, c, tm, lens):
    """The JAX dense kernel (``"kernel"``, interpret mode, model layout)
    or oracle (``"ref"``, kernel layout); returns the model layout."""
    import jax.numpy as jnp
    from repro.kernels.tree_attention.ops import tree_attention_bshd
    from repro.kernels.tree_attention.ref import tree_attention_ref

    j = {k: jnp.asarray(v) for k, v in c.items()}
    tmj, lj = jnp.asarray(tm), jnp.asarray(lens, jnp.int32)
    if name == "kernel":
        return np.asarray(tree_attention_bshd(
            j["q"], j["ck"], j["cv"], j["tk"], j["tv"], tmj, lj,
            interpret=True))
    tr = lambda t: t.transpose(0, 2, 1, 3)
    o = tree_attention_ref(tr(j["q"]), tr(j["ck"]), tr(j["cv"]), tr(j["tk"]),
                           tr(j["tv"]), tmj, lj)
    return np.asarray(o).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("T", [16, 13, 5])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_matches_jax_kernel_and_ref(T, Hq, Hkv):
    """Ragged lens with an empty slot; T not a multiple of 8 is padded by
    the wrapper and sliced back."""
    B, D, S = 3, 64, 96
    lens = [40, 0, S - T]
    c = _case(T + Hkv, B, T, Hq, Hkv, D, S, lens)
    tm = default_tree(T, 4, 4).ancestor_mask
    out = _port(c, tm, lens)
    assert out.shape == (B, T, Hq, D)
    np.testing.assert_allclose(out, _jax("kernel", c, tm, lens), **TOL)
    np.testing.assert_allclose(out, _jax("ref", c, tm, lens), **TOL)


@pytest.mark.parametrize("fill", [1e4, -1e4, 7.0])
def test_positions_past_cache_len_never_reach_output(fill):
    """Finite garbage at or past cache_len (stale scratch, other rows'
    writes) does not change one output bit."""
    B, T, Hq, Hkv, D, S = 2, 8, 4, 2, 64, 64
    lens = [19, 33]
    tm = default_tree(T, 2, 3).ancestor_mask
    base = _port(_case(3, B, T, Hq, Hkv, D, S, lens, fill=0.0), tm, lens)
    poisoned = _port(_case(3, B, T, Hq, Hkv, D, S, lens, fill=fill), tm,
                     lens)
    np.testing.assert_array_equal(base, poisoned)


def test_plain_is_the_dense_verify_it_replaces():
    """The plain version is bit for bit what the dense verify branch ran
    before K2: scatter the tree, ``masked_attention`` under the mask."""
    B, T, Hq, Hkv, D, S = 2, 16, 4, 2, 64, 80
    lens = torch.tensor([20, 51], dtype=torch.int32)
    c = {k: torch.from_numpy(v)
         for k, v in _case(4, B, T, Hq, Hkv, D, S, [20, 51]).items()}
    tm = torch.from_numpy(default_tree(T, 4, 4).ancestor_mask)
    out = tree_attention_dense_plain(c["q"], c["ck"], c["cv"], c["tk"],
                                     c["tv"], tm, lens)
    ck, cv = c["ck"].clone(), c["cv"].clone()
    attention._dense_scatter(ck, c["tk"], lens)
    attention._dense_scatter(cv, c["tv"], lens)
    ai = attention.AttnInputs(q_pos=None, cache_k=ck, cache_v=cv,
                              cache_len=lens, tree_mask=tm, window=0,
                              causal=True)
    from repro_torch.models.layers import masked_attention
    ref = masked_attention(c["q"], ck, cv,
                           attention._verify_mask(ai, B, T, S))
    assert torch.equal(out, ref)


def test_dense_verify_dispatch(monkeypatch):
    """``gqa_fwd``'s dense verify calls K2's wrapper at window 0 only; a
    sliding-window layer keeps ``masked_attention``."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import init_gqa

    cfg = get_config("minitron-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = init_gqa(gen, cfg, torch.float32, "cpu")
    calls = []
    fn = attention.tree_attention_bshd
    monkeypatch.setattr(attention, "tree_attention_bshd",
                        lambda *a: calls.append(1) or fn(*a))
    B, T, S = 2, 5, 32
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    lens = torch.tensor([7, 12], dtype=torch.int32)
    for window, n in ((0, 1), (4, 1)):
        ai = attention.AttnInputs(
            q_pos=lens[:, None] + torch.arange(T), cache_k=torch.zeros(shape),
            cache_v=torch.zeros(shape), cache_len=lens, tree_mask=None,
            window=window, causal=True)
        attention.gqa_fwd(p, cfg, torch.randn(B, T, cfg.d_model), ai)
        assert len(calls) == n


def test_wrapper_rejects_bad_operands():
    B, T, Hq, Hkv, D, S = 1, 8, 4, 2, 64, 32
    c = {k: torch.from_numpy(v)
         for k, v in _case(5, B, T, Hq, Hkv, D, S, [4]).items()}
    tm = torch.ones((T, T), dtype=torch.bool).tril()
    lens = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="caches"):
        dense_ops.tree_attention_bshd(c["q"], c["ck"][..., :32], c["cv"],
                                      c["tk"], c["tv"], tm, lens)
    with pytest.raises(ValueError, match="tree K/V"):
        dense_ops.tree_attention_bshd(c["q"], c["ck"], c["cv"],
                                      c["tk"][:, :4], c["tv"], tm, lens)
    with pytest.raises(ValueError, match="tree_mask"):
        dense_ops.tree_attention_bshd(c["q"], c["ck"], c["cv"], c["tk"],
                                      c["tv"], tm.int(), lens)
    with pytest.raises(ValueError, match="cache_len must be int32"):
        dense_ops.check_cuda_operands(c["q"], c["ck"], c["cv"], c["tk"],
                                      c["tv"], tm, lens.long())
    # any number of query rows per kv head is taken (160: three row
    # groups); what the grid cannot hold, more (b, kv head) pairs than
    # its extent, is refused
    q = torch.zeros((1, 40, 8, 256))
    kv = torch.zeros((1, 40, 2, 256))
    dense_ops.check_cuda_operands(
        q, torch.zeros((1, 64, 2, 256)), torch.zeros((1, 64, 2, 256)),
        kv, kv, torch.ones((40, 40), dtype=torch.bool), lens)
    with pytest.raises(ValueError, match="exceed"):
        B = 65536
        q = torch.empty((B, 1, 1, 64))
        dense_ops.check_cuda_operands(
            q, torch.empty((B, 4, 1, 64)), torch.empty((B, 4, 1, 64)), q, q,
            torch.ones((1, 1), dtype=torch.bool),
            torch.zeros(B, dtype=torch.int32))


def test_cpu_path_launches_no_kernel():
    c = _case(6, 1, 8, 2, 2, 64, 32, [5])
    before = dense_ops.launches
    _port(c, np.tril(np.ones((8, 8), bool)), [5])
    assert dense_ops.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T", [16, 5])
@pytest.mark.parametrize("Hq,Hkv,D", [(24, 8, 128), (4, 1, 256)])
def test_cuda_kernel_matches_plain(dtype, tol, T, Hq, Hkv, D):
    """The hand-written kernel against its plain version on the card at
    minitron-4b and gemma3-1b global-layer head shapes, ragged lens; then
    NaN and inf at or past cache_len change no output bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S = 4, 512
    lens = [0, 37, 144, 300]
    dt = getattr(torch, dtype)
    tm = torch.from_numpy(default_tree(T, 4, 4).ancestor_mask).cuda()
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    outs = []
    for fill in (0.0, np.nan, np.inf):
        c = _case(8, B, T, Hq, Hkv, D, S, lens, fill=fill)
        t = {k: torch.from_numpy(v).to("cuda", dt) for k, v in c.items()}
        args = (t["q"], t["ck"], t["cv"], t["tk"], t["tv"], tm, lens_t)
        before = dense_ops.launches
        outs.append(dense_ops.tree_attention_bshd(*args))
        torch.cuda.synchronize()
        assert dense_ops.launches == before + 1
        if fill == 0.0:
            ref = tree_attention_dense_plain(*args)
            torch.testing.assert_close(outs[0].float(), ref.float(),
                                       atol=tol, rtol=tol)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
