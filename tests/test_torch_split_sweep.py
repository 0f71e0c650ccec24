"""The split cache sweep of the tree-verify kernel (K1, K4, K2) in plain
PyTorch, against the unsplit plain versions and the JAX kernels.

The CUDA kernel gives each (split, b, kv head) a block that leaves a
partial ``(m, l, acc)`` per query row, then a merge folds the partials in
split order and the tree partial last (``kernels/tree_attention/
split.py``).  Here the split's plain version equals, for ``split_len`` in
{16, 32, 64, one split over the whole capacity}:

* the unsplit plain versions (``tree_attention_paged_plain``,
  ``tree_attention_paged_windowed_plain``, ``tree_attention_dense_plain``)
  at ``atol = rtol = 2e-6`` (fp32; only the order of the sums differs);
* the JAX kernels ``tree_attention_paged``,
  ``tree_attention_paged_windowed_bshd`` and ``tree_attention`` (dense),
  in interpret mode as the JAX tests run them, at ``atol = rtol = 2e-5``
  (fp32, as the other parity tests of the port);

with NULL holes below ``cache_len``, a slot at ``cache_len`` 0, splits
wholly behind the window, and the dense form.  Folding an empty partial
is bitwise the identity, and the planner splits a paged and a dense call
of equal B*Hkv at the same positions whatever their capacities and pool
block sizes (8 to 128; at 128 a split starts inside a block), so the two
fold alike bit for bit.  The kernel at forced split lengths against the
split's plain version, and K1 == K2 bitwise at block 128, are the
``gpu``-marked cases; they skip without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_split_sweep.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.attention_template.ref import (  # noqa: E402
    tree_attention_paged_windowed_plain)
from repro_torch.kernels.tree_attention import ops, split  # noqa: E402
from repro_torch.kernels.tree_attention.kernel import (  # noqa: E402
    tree_attention_dense_plain, tree_attention_paged_plain)

torch.set_num_threads(2)
PLAIN_TOL = dict(atol=2e-6, rtol=2e-6)
JAX_TOL = dict(atol=2e-5, rtol=2e-5)
BS = 16
SPLITS = [16, 32, 64, 4096]          # the last is one split over it all


def _paged_case(seed, lens, T, Hq, Hkv, D, holes=(), bs=BS):
    """fp32 operands from a numpy seed (model layout): ascending-id tables
    of ``bs``-position blocks covering [0, len + T) per slot, ``holes``
    punched back to NULL, the NULL block poisoned with NaN, and the verify
    positions."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    B = len(lens)
    need = [-(-(n + T) // bs) for n in lens]
    M = max(need) + 1
    table = np.zeros((B, M), np.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    for b, j in holes:
        table[b, j] = 0
    c = dict(q=r(B, T, Hq, D), pool_k=r(nxt, bs, Hkv, D),
             pool_v=r(nxt, bs, Hkv, D), tree_k=r(B, T, Hkv, D),
             tree_v=r(B, T, Hkv, D))
    c["pool_k"][0] = np.nan
    c["pool_v"][0] = np.nan
    tree = default_tree(T, 2, 3)
    lens = np.asarray(lens, np.int32)
    q_pos = (lens[:, None] + tree.depth[None, :]).astype(np.int32)
    return c, tree.ancestor_mask, lens, table, q_pos


def _torch(c, tm, lens, table):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm), torch.from_numpy(lens),
            torch.from_numpy(table))


def _jax_paged(c, tm, lens, table, q_pos=None, window=0):
    """JAX's K1 (``tree_attention_paged``) or, with q_pos, K4
    (``tree_attention_paged_windowed_bshd``), interpret mode, returned in
    the model layout."""
    import jax.numpy as jnp
    from repro.kernels.attention_template.ops import (
        tree_attention_paged_windowed_bshd)
    from repro.kernels.tree_attention.kernel import tree_attention_paged

    a = {k: jnp.asarray(v) for k, v in c.items()}
    if q_pos is not None:
        return np.asarray(tree_attention_paged_windowed_bshd(
            a["q"], a["pool_k"], a["pool_v"], a["tree_k"], a["tree_v"],
            jnp.asarray(tm), jnp.asarray(lens), jnp.asarray(table),
            jnp.asarray(q_pos), jnp.int32(window), interpret=True))
    tr = lambda x: x.transpose(0, 2, 1, 3)
    o = tree_attention_paged(tr(a["q"]), a["pool_k"], a["pool_v"],
                             tr(a["tree_k"]), tr(a["tree_v"]),
                             jnp.asarray(tm), jnp.asarray(lens),
                             jnp.asarray(table), interpret=True)
    return np.asarray(o).transpose(0, 2, 1, 3)


# a slot at cache_len 0, one with a NULL hole, one long enough that its
# first splits lie wholly behind a window of 24
LENS, HOLES = [0, 37, 100], [(1, 1)]


@pytest.mark.parametrize("split_len", SPLITS)
def test_paged_split_matches_plain_and_jax(split_len):
    c, tm, lens, table, _ = _paged_case(1, LENS, 8, 4, 2, 64, HOLES)
    args = _torch(c, tm, lens, table)
    out = split.tree_attention_paged_split(*args, split_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, tree_attention_paged_plain(*args),
                               **PLAIN_TOL)
    np.testing.assert_allclose(out.numpy(), _jax_paged(c, tm, lens, table),
                               **JAX_TOL)


@pytest.mark.parametrize("split_len", SPLITS)
def test_windowed_split_matches_plain_and_jax(split_len):
    window = 24
    c, tm, lens, table, q_pos = _paged_case(2, LENS, 8, 4, 1, 64, HOLES)
    args = _torch(c, tm, lens, table)
    qp = torch.from_numpy(q_pos)
    out = split.tree_attention_paged_split(*args, split_len, qp, window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out, tree_attention_paged_windowed_plain(*args, qp, window),
        **PLAIN_TOL)
    np.testing.assert_allclose(
        out.numpy(), _jax_paged(c, tm, lens, table, q_pos, window),
        **JAX_TOL)


def test_window_0_split_is_k1_split_bitwise():
    c, tm, lens, table, q_pos = _paged_case(3, LENS, 8, 4, 2, 64, HOLES)
    args = _torch(c, tm, lens, table)
    assert torch.equal(
        split.tree_attention_paged_split(*args, 32,
                                         torch.from_numpy(q_pos), 0),
        split.tree_attention_paged_split(*args, 32))


@pytest.mark.parametrize("split_len", SPLITS)
def test_dense_split_matches_plain_and_jax(split_len):
    import jax.numpy as jnp
    from repro.kernels.tree_attention.ops import tree_attention_bshd

    B, T, Hq, Hkv, D, S = 3, 8, 4, 2, 64, 128
    rs = np.random.default_rng(4)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    c = dict(q=r(B, T, Hq, D), ck=r(B, S, Hkv, D), cv=r(B, S, Hkv, D),
             tk=r(B, T, Hkv, D), tv=r(B, T, Hkv, D))
    lens = np.asarray([0, 37, 100], np.int32)
    tm = default_tree(T, 2, 3).ancestor_mask
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    args = (t["q"], t["ck"], t["cv"], t["tk"], t["tv"], torch.from_numpy(tm),
            torch.from_numpy(lens))
    out = split.tree_attention_dense_split(*args, split_len)
    torch.testing.assert_close(out, tree_attention_dense_plain(*args),
                               **PLAIN_TOL)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    ref = tree_attention_bshd(j["q"], j["ck"], j["cv"], j["tk"], j["tv"],
                              jnp.asarray(tm), jnp.asarray(lens),
                              interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **JAX_TOL)


def test_paged_and_dense_split_agree_bitwise():
    """A paged call without holes and the dense call over the same keys
    fold the same partials in the same order: equal bit for bit."""
    c, tm, lens, table, _ = _paged_case(5, LENS, 8, 4, 2, 64)
    args = _torch(c, tm, lens, table)
    B, M = table.shape
    t = torch.from_numpy(table).long()
    view = lambda pool: pool[t].reshape(B, M * BS, *pool.shape[2:])
    dense = split.tree_attention_dense_split(
        args[0], view(args[1]), view(args[2]), *args[3:7], 32)
    assert torch.equal(split.tree_attention_paged_split(*args, 32), dense)


def test_folding_an_empty_partial_is_bitwise_identity():
    rs = np.random.default_rng(6)
    shape, D = (2, 3, 24), 64
    state = (torch.from_numpy(rs.standard_normal(shape, dtype=np.float32)),
             torch.from_numpy(rs.random(shape, dtype=np.float32) + 0.5),
             torch.from_numpy(rs.standard_normal((*shape, D),
                                                 dtype=np.float32)))
    empty = split.empty_partial(shape, D)
    for got, want in zip(split.fold(state, empty), state):
        assert torch.equal(got, want)
    # and the empty running state takes the first partial as it is
    for got, want in zip(split.fold(empty, state), state):
        assert torch.equal(got, want)
    # an empty partial whose acc holds garbage is never read
    junk = (empty[0], empty[1], torch.full((*shape, D), float("nan")))
    for got, want in zip(split.fold(state, junk), state):
        assert torch.equal(got, want)


# the pool block sizes the CUDA path admits are multiples of 8
BLOCK_SIZES = (8, 16, 32, 64, 128)


@pytest.mark.parametrize("B,Hkv", [(1, 1), (4, 1), (4, 8), (4, 16), (1, 16),
                                   (16, 32), (64, 64)])
def test_planner_splits_paged_and_dense_alike(B, Hkv):
    """The split depends on B*Hkv alone: a paged call at every block size
    the CUDA path admits and a dense call of any capacities start their
    splits at the same positions, and the split is a multiple of 16 that
    the kernel's check takes whatever the block size."""
    split_len = split.plan_split_len(B, Hkv)
    assert split_len % 16 == 0
    ops.check_split_len(split_len)
    starts = lambda cap: [s * split_len
                          for s in range(split.n_splits(cap, split_len))]
    for bs in BLOCK_SIZES:
        for m, dense_cap in ((512 // bs, 2048), (2048 // bs, 1536),
                             (96, 100)):
            a, b = starts(m * bs), starts(dense_cap)
            n = min(len(a), len(b))
            assert a[:n] == b[:n]


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_paged_split_at_block_size_folds_as_dense(bs):
    """At every admitted block size (128 does not divide the planner's 64)
    the paged split's plain version folds the same partials in the same
    order as the dense one over the same keys: equal bit for bit."""
    c, tm, lens, table, _ = _paged_case(8, LENS, 8, 4, 2, 64, bs=bs)
    args = _torch(c, tm, lens, table)
    B, M = table.shape
    t = torch.from_numpy(table).long()
    view = lambda pool: pool[t].reshape(B, M * bs, *pool.shape[2:])
    split_len = split.plan_split_len(B, 2)
    assert split_len == 64
    dense = split.tree_attention_dense_split(
        args[0], view(args[1]), view(args[2]), *args[3:7], split_len)
    paged = split.tree_attention_paged_split(*args, split_len)
    assert torch.equal(paged, dense)
    torch.testing.assert_close(paged, tree_attention_paged_plain(*args),
                               **PLAIN_TOL)


def test_planner_grows_with_the_grid():
    assert split.plan_split_len(4, 1) == 64           # gemma3-1b: 4 heads
    assert split.plan_split_len(4, 8) == 64           # minitron-4b: 32
    assert split.plan_split_len(4, 16) == 128         # deepseek prefix: 64
    assert split.plan_split_len(1024, 64) == 1024     # capped


def test_wrapper_checks_a_forced_split():
    for good in (16, 48, 64, 4096):
        ops.check_split_len(good)
    for bad in (0, -16, 24):
        with pytest.raises(ValueError):
            ops.check_split_len(bad)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("split_len", [16, 64, None, 4096])
def test_cuda_kernel_at_forced_splits(dtype, tol, split_len):
    """The kernel at forced split lengths (and the planner's) against the
    split's plain version on the card, with holes and a poisoned NULL;
    two identical calls are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c, tm, lens, table, _ = _paged_case(7, [0, 37, 300, 80], 16, 24, 8, 128,
                                        [(1, 1)])
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to("cuda", dt) for k, v in c.items()}
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm).cuda(), torch.from_numpy(lens).cuda(),
            torch.from_numpy(table).cuda())
    out = ops.tree_attention_paged_bshd(*args, split_len=split_len)
    again = ops.tree_attention_paged_bshd(*args, split_len=split_len)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = split.tree_attention_paged_split(
        *args, split_len or split.plan_split_len(4, 8))
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_equals_dense_at_block_128(dtype):
    """K1 over a pool of 128-position blocks and K2 over the same keys as
    a dense cache, at minitron-4b's heads (24 q over 8 kv, D=128) and
    T=16: both split at the planner's 64, inside the pool blocks, and
    fold alike, so the outputs are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.tree_attention import dense_ops

    c, tm, lens, table, _ = _paged_case(9, [0, 37, 300, 200], 16, 24, 8,
                                        128, bs=128)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to("cuda", dt) for k, v in c.items()}
    tbl = torch.from_numpy(table).cuda()
    B, M = table.shape
    view = lambda pool: pool[tbl.long()].reshape(
        B, M * 128, *pool.shape[2:]).contiguous()
    common = (t["tree_k"], t["tree_v"], torch.from_numpy(tm).cuda(),
              torch.from_numpy(lens).cuda())
    paged = ops.tree_attention_paged_bshd(t["q"], t["pool_k"], t["pool_v"],
                                          *common, tbl)
    dense = dense_ops.tree_attention_bshd(t["q"], view(t["pool_k"]),
                                          view(t["pool_v"]), *common)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [8, 16, 128])
def test_cuda_f32_paged_equals_dense_at_any_block(bs):
    """fp32 K1 over a pool of ``bs``-position blocks and K2 over the same
    keys as a dense cache, at minitron-4b's heads and T=16: both take
    their key tiles at the split's own positions, gathering each key
    through the table, so they are equal bit for bit whatever the block
    size (the first fp32 body cut its tiles at the pool's block edges)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.tree_attention import dense_ops

    c, tm, lens, table, _ = _paged_case(13, [0, 37, 300, 200], 16, 24, 8,
                                        128, bs=bs)
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    tbl = torch.from_numpy(table).cuda()
    B, M = table.shape
    view = lambda pool: pool[tbl.long()].reshape(
        B, M * bs, *pool.shape[2:]).contiguous()
    common = (t["tree_k"], t["tree_v"], torch.from_numpy(tm).cuda(),
              torch.from_numpy(lens).cuda())
    paged = ops.tree_attention_paged_bshd(t["q"], t["pool_k"], t["pool_v"],
                                          *common, tbl)
    dense = dense_ops.tree_attention_bshd(t["q"], view(t["pool_k"]),
                                          view(t["pool_v"]), *common)
    torch.cuda.synchronize()
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 1, 256), (24, 8, 128), (4, 4, 64)])
def test_cuda_f32_windowed_at_window_0_is_k1(Hq, Hkv, D):
    """fp32 K4 at window 0 (and at a negative window) equals K1 bit for
    bit, with holes and a NaN-poisoned NULL block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.attention_template import ops as wops

    c, tm, lens, table, q_pos = _paged_case(14, [0, 37, 700, 300], 16, Hq,
                                            Hkv, D, [(2, 20), (3, 0)])
    t = {k: torch.from_numpy(v).cuda() for k, v in c.items()}
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm).cuda(), torch.from_numpy(lens).cuda(),
            torch.from_numpy(table).cuda())
    qp = torch.from_numpy(q_pos).cuda()
    k1 = ops.tree_attention_paged_bshd(*args)
    outs = [wops.tree_attention_paged_windowed_bshd(*args, qp, w)
            for w in (0, -3)]
    torch.cuda.synchronize()
    assert torch.isfinite(k1).all()
    for o in outs:
        assert torch.equal(o, k1)
