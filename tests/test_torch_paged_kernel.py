"""The port's paged tree-verify attention against the JAX reference.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
these tests hold it against the JAX Pallas kernel (interpret mode) and the
JAX oracle ``tree_attention_paged_ref`` on the cases of
``tests/test_paged_kernel.py``: ragged lengths, GQA grouping, NULL holes
below ``cache_len``, a poisoned NULL block (plus NaN and inf for the
port) and T padding.  Tolerance ``atol = rtol = 2e-5`` (fp32, the two
sides sum in different orders).  The CUDA kernel against the plain
version is the ``gpu``-marked case; it skips without a card.  The JAX
side is imported inside the helper that runs it, so the ``gpu`` case also
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_paged_kernel.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.tree_attention import ops  # noqa: E402
from repro_torch.kernels.tree_attention.kernel import (  # noqa: E402
    tree_attention_paged_plain)

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, B, T, Hq, Hkv, D, N, bs):
    """Random fp32 inputs from a numpy seed, in the MODEL layout."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    return dict(q=r(B, T, Hq, D), pool_k=r(N, bs, Hkv, D),
                pool_v=r(N, bs, Hkv, D), tree_k=r(B, T, Hkv, D),
                tree_v=r(B, T, Hkv, D))


def _cover_tables(lens, T, bs, M, num_blocks, holes=()):
    """Ascending-id tables covering [0, len + T) per row; ``holes``:
    (row, logical block) entries punched back to NULL."""
    table = np.zeros((len(lens), M), np.int32)
    nxt = 1
    for b, L in enumerate(lens):
        need = -(-max(int(L) + T, 1) // bs)
        assert need <= M and nxt + need <= num_blocks
        table[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    for b, j in holes:
        table[b, j] = 0
    return table


def _port(c, tm, lens, table):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return ops.tree_attention_paged_bshd(
        t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
        torch.from_numpy(tm), torch.tensor(lens, dtype=torch.int32),
        torch.from_numpy(table)).numpy()


def _jax(name, c, tm, lens, table):
    """Run the JAX kernel (``"kernel"``, interpret mode) or oracle
    (``"ref"``) in its kernel layout; return the model layout."""
    import jax.numpy as jnp
    from repro.kernels.tree_attention.kernel import tree_attention_paged
    from repro.kernels.tree_attention.ref import tree_attention_paged_ref

    fn, kw = ((tree_attention_paged, {"interpret": True}) if name == "kernel"
              else (tree_attention_paged_ref, {}))
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    o = fn(tr(c["q"]), jnp.asarray(c["pool_k"]), jnp.asarray(c["pool_v"]),
           tr(c["tree_k"]), tr(c["tree_v"]), jnp.asarray(tm),
           jnp.asarray(lens, jnp.int32), jnp.asarray(table), **kw)
    return np.asarray(o).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("bs,M,num_blocks", [(16, 8, 32), (128, 3, 8)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_plain_matches_jax_kernel_and_ref(bs, M, num_blocks, Hq, Hkv):
    """Ragged lens: a row with a partial last block, an empty row."""
    B, T, D = 3, 8, 64
    lens = [bs * 2 + 5, 0, min(M * bs - T, bs * 3)]
    c = _case(bs + Hkv, B, T, Hq, Hkv, D, num_blocks, bs)
    tm = default_tree(T, 2, 3).ancestor_mask
    table = _cover_tables(lens, T, bs, M, num_blocks)
    out = _port(c, tm, lens, table)
    np.testing.assert_allclose(
        out, _jax("kernel", c, tm, lens, table),
        **TOL)
    np.testing.assert_allclose(
        out, _jax("ref", c, tm, lens, table), **TOL)


def test_null_holes_are_masked():
    """NULL holes strictly below cache_len are skipped like the JAX
    kernel skips them, and the result differs from reading the holes."""
    B, Hq, Hkv, T, D, bs, M, N = 2, 2, 2, 8, 64, 16, 6, 16
    lens = [bs * 4, bs * 3 + 7]
    c = _case(3, B, T, Hq, Hkv, D, N, bs)
    tm = np.tril(np.ones((T, T), bool))
    table = _cover_tables(lens, T, bs, M, N, holes=[(0, 1), (1, 0)])
    out = _port(c, tm, lens, table)
    np.testing.assert_allclose(
        out, _jax("kernel", c, tm, lens, table),
        **TOL)
    full = _port(c, tm, lens, _cover_tables(lens, T, bs, M, N))
    assert np.max(np.abs(out - full)) > 1e-3


@pytest.mark.parametrize("fill", [1e4, -1e4, np.nan, np.inf, -np.inf])
def test_poisoned_null_block_never_reaches_output(fill):
    """Whatever physical block 0 holds, not one output bit changes: via
    the unallocated tail nor via a hole below cache_len."""
    B, Hq, Hkv, T, D, bs, M, N = 2, 4, 2, 8, 64, 16, 6, 16
    lens = [bs * 2 + 3, bs * 3]
    c = _case(4, B, T, Hq, Hkv, D, N, bs)
    tm = default_tree(T, 2, 3).ancestor_mask
    table = _cover_tables(lens, T, bs, M, N, holes=[(1, 1)])
    outs = []
    for f in (0.0, fill):
        cc = dict(c, pool_k=c["pool_k"].copy(), pool_v=c["pool_v"].copy())
        cc["pool_k"][0] = f
        cc["pool_v"][0] = f
        outs.append(_port(cc, tm, lens, table))
    assert np.isfinite(outs[1]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(
        outs[0], _jax("kernel", c, tm, lens, table), **TOL)


def test_wrapper_pads_T():
    """T=13 is padded to 16 around the plain version and sliced back; the
    result matches the unpadded JAX oracle."""
    B, T, Hq, Hkv, D, bs, M, N = 2, 13, 2, 1, 64, 16, 6, 16
    tm = default_tree(13, 4, 4).ancestor_mask
    lens = [9, bs * 2 + 1]
    c = _case(5, B, T, Hq, Hkv, D, N, bs)
    table = _cover_tables(lens, T, bs, M, N)
    out = _port(c, tm, lens, table)
    assert out.shape == (B, T, Hq, D)
    np.testing.assert_allclose(
        out, _jax("ref", c, tm, lens, table), **TOL)


def test_wrapper_rejects_block_size_not_multiple_of_8():
    B, T, Hq, Hkv, D, bs = 1, 8, 2, 2, 64, 12
    c = _case(6, B, T, Hq, Hkv, D, 4, bs)
    tm = np.tril(np.ones((T, T), bool))
    with pytest.raises(ValueError, match="multiple of 8"):
        _port(c, tm, [bs], np.array([[1, 2, 0]], np.int32))


def test_cpu_path_launches_no_kernel():
    """The launch counter counts kernel launches only: the plain version
    on CPU tensors leaves it alone."""
    B, T, Hq, Hkv, D, bs, M, N = 1, 8, 2, 2, 64, 16, 2, 4
    c = _case(7, B, T, Hq, Hkv, D, N, bs)
    before = ops.launches
    _port(c, np.tril(np.ones((T, T), bool)), [5],
          _cover_tables([5], T, bs, M, N))
    assert ops.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T", [16, 5])
def test_cuda_kernel_matches_plain(dtype, tol, T):
    """The hand-written kernel against its plain version on the card, at
    minitron-4b head shapes, ragged lens, holes and a poisoned NULL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Hq, Hkv, D, bs, M, N = 4, 24, 8, 128, 16, 16, 80
    lens = [0, 37, bs * 5, 200]
    c = _case(8, B, T, Hq, Hkv, D, N, bs)
    c["pool_k"][0] = np.nan
    c["pool_v"][0] = np.inf
    table = torch.from_numpy(_cover_tables(lens, T, bs, M, N,
                                           holes=[(2, 1)])).cuda()
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to("cuda", dt) for k, v in c.items()}
    tm = torch.from_numpy(default_tree(T, 4, 4).ancestor_mask).cuda()
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"], tm,
            lens_t, table)
    before = ops.launches
    out = ops.tree_attention_paged_bshd(*args)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = tree_attention_paged_plain(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("lens", [(32, 48, 64, 80), (0, 37, 300, 500)])
def test_cuda_f32_at_vicuna_tiny_heads(lens):
    """fp32 K1 (3xTF32 on the tensor cores) at vicuna-tiny's verify: 4 q
    over 4 kv heads of 64, T=16, block 16, against its plain version at
    1e-4, with a hole below cache_len and a NaN-poisoned NULL block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, H, D, bs, M, N = 4, 16, 4, 64, 16, 40, 80
    c = _case(11, B, T, H, H, D, N, bs)
    c["pool_k"][0] = np.nan
    c["pool_v"][0] = np.nan
    table = torch.from_numpy(_cover_tables(lens, T, bs, M, N,
                                           holes=[(3, 1)])).cuda()
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    tm = torch.from_numpy(default_tree(T, 4, 4).ancestor_mask).cuda()
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"], tm,
            torch.tensor(lens, dtype=torch.int32, device="cuda"), table)
    before = ops.f32_launches
    out = ops.tree_attention_paged_bshd(*args)
    torch.cuda.synchronize()
    assert ops.f32_launches == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tree_attention_paged_plain(*args),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D", [(24, 8, 128), (4, 1, 256), (4, 4, 64)])
def test_cuda_f32_poisoned_null_block_and_repeat(Hq, Hkv, D):
    """fp32 K1: the NULL block filled with 0, +-1e4, NaN, inf or -inf
    changes no bit of the output, and two identical calls are bitwise
    equal (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, T, bs, M, N = 4, 16, 16, 16, 80
    lens = [0, 37, bs * 5, 200]
    table = torch.from_numpy(_cover_tables(lens, T, bs, M, N,
                                           holes=[(2, 1), (3, 0)])).cuda()
    tm = torch.from_numpy(default_tree(T, 4, 4).ancestor_mask).cuda()
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    outs = []
    for fill in (0.0, 1e4, -1e4, np.nan, np.inf, -np.inf):
        c = _case(12, B, T, Hq, Hkv, D, N, bs)
        c["pool_k"][0] = fill
        c["pool_v"][0] = fill
        t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
        outs.append(ops.tree_attention_paged_bshd(
            t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"], tm,
            lens_t, table))
    outs.append(ops.tree_attention_paged_bshd(
        t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"], tm,
        lens_t, table))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0]).all()
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
