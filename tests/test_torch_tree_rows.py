"""The tree-verify kernel (K1 paged, K4 windowed, K2 dense) past 64 query
rows per kv head, against the JAX oracle ``repro/kernels/tree_attention/
ref.py``.

The CUDA kernel holds 64 of a kv head's R = G*T query rows (row g*T + t:
query head h*G + g, tree token t) in one split block, and takes any R by
giving each row group of 64 blocks of its own (``split.py::row_groups``).
Here, at the head groupings of qwen2.5-32b (40 q over 8 kv heads, G = 5),
chameleon-34b (64 over 8, G = 8) and starcoder2-7b (36 over 4, G = 9), at
T = 16 (80, 128 and 144 rows) and at T = 20, which the wrappers pad to 24
(120, 192 and 216 rows; a head's 24 rows then straddle two row groups),
head dim 64, fp32 from a numpy seed:

* the split sweep's plain version (``split.py``) at one split, the
  planner's and 16, paged and dense, equals the JAX oracle within
  ``atol = rtol = 2e-5`` (the split tests' tolerance), and so do the
  wrappers' CPU paths (K1, K2, and K4 at window 0); K4 at a window of 24
  equals the windowed split's plain version within 2e-6;
* the planner counts row groups as blocks of a split column: every call
  of at most 64 rows keeps its split;
* ``gpu``-marked, on the card: the kernel against its plain version at
  those row counts (fp32 1e-4, bf16 2e-2) with the NULL block poisoned,
  two identical calls bitwise equal; and the rows of a subset of heads
  (the first 4 of each kv head's G at T = 16: one row group) bitwise
  equal to a call on that subset alone at the same split, so row groups
  share nothing.  Run them with

    python -m pytest --noconftest -m gpu tests/test_torch_tree_rows.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.attention_template import ops as wops  # noqa: E402
from repro_torch.kernels.tree_attention import dense_ops, ops, split  # noqa: E402,E501

torch.set_num_threads(2)
JAX_TOL = dict(atol=2e-5, rtol=2e-5)
PLAIN_TOL = dict(atol=2e-6, rtol=2e-6)
BS = 16
D = 64
# (q heads, kv heads) of qwen2.5-32b, chameleon-34b and starcoder2-7b
HEADS = {"qwen2.5-32b": (40, 8), "chameleon-34b": (64, 8),
         "starcoder2-7b": (36, 4)}
LENS, HOLES = [0, 37, 100], [(1, 1)]


def _case(seed, Hq, Hkv, T, lens=LENS, holes=HOLES, garbage=1e4, d=D):
    """fp32 operands (model layout) from a numpy seed: ascending-id tables
    of 16-position blocks covering [0, len + T) per slot, ``holes`` punched
    back to NULL, the NULL block filled with ``garbage`` (finite: the JAX
    oracle multiplies its masked weights by the values), the verify
    positions, and the dense view of the same keys."""
    rs = np.random.default_rng(seed)
    r = lambda *s: rs.standard_normal(s, dtype=np.float32)
    B = len(lens)
    need = [-(-(n + T) // BS) for n in lens]
    M = max(need) + 1
    table = np.zeros((B, M), np.int32)
    nxt = 1
    for b, n in enumerate(need):
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    for b, j in holes:
        table[b, j] = 0
    c = dict(q=r(B, T, Hq, d), pool_k=r(nxt, BS, Hkv, d),
             pool_v=r(nxt, BS, Hkv, d), tree_k=r(B, T, Hkv, d),
             tree_v=r(B, T, Hkv, d))
    c["pool_k"][0] = garbage
    c["pool_v"][0] = garbage
    tree = default_tree(T, 4, 4)
    lens = np.asarray(lens, np.int32)
    q_pos = (lens[:, None] + tree.depth[None, :]).astype(np.int32)
    return c, tree.ancestor_mask, lens, table, q_pos


def _torch(c, tm, lens, table):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm), torch.from_numpy(lens),
            torch.from_numpy(table))


def _dense_view(args):
    """The paged operands' keys as a dense per-slot cache (holes and the
    NULL block included, all below or past cache_len as the table puts
    them) and the operands K2 takes."""
    q, pool_k, pool_v, tk, tv, tm, lens, table = args
    B, M = table.shape
    t = table.long()
    view = lambda pool: pool[t].reshape(B, M * BS, *pool.shape[2:])
    return q, view(pool_k), view(pool_v), tk, tv, tm, lens


def _jax_ref(c, tm, lens, table, dense=None):
    """The JAX oracle (``tree_attention_paged_ref``, or with ``dense`` =
    (cache_k, cache_v) ``tree_attention_ref``), in the model layout."""
    import jax.numpy as jnp
    from repro.kernels.tree_attention.ref import (tree_attention_paged_ref,
                                                  tree_attention_ref)

    tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    if dense is None:
        o = tree_attention_paged_ref(
            tr(c["q"]), jnp.asarray(c["pool_k"]), jnp.asarray(c["pool_v"]),
            tr(c["tree_k"]), tr(c["tree_v"]), jnp.asarray(tm),
            jnp.asarray(lens), jnp.asarray(table))
    else:
        o = tree_attention_ref(
            tr(c["q"]), tr(dense[0]), tr(dense[1]), tr(c["tree_k"]),
            tr(c["tree_v"]), jnp.asarray(tm), jnp.asarray(lens))
    return np.asarray(o).transpose(0, 2, 1, 3)


def _padded(args, T):
    """The operands with T padded as the wrappers pad it."""
    q, pk, pv, tk, tv, tm, lens, table = args
    q, tk, tv, tm, _ = ops.pad_tree(q, tk, tv, tm)
    return q, pk, pv, tk, tv, tm, lens, table


def _splits(q, Hkv):
    """One split over a 256-position capacity, the planner's and 16."""
    return (256, ops.planned_split_len(q, Hkv), 16)


@pytest.mark.parametrize("T", [16, 20])
@pytest.mark.parametrize("arch", HEADS)
def test_paged_split_matches_jax_ref(arch, T):
    Hq, Hkv = HEADS[arch]
    c, tm, lens, table, _ = _case(1, Hq, Hkv, T)
    args = _padded(_torch(c, tm, lens, table), T)
    assert (Hq // Hkv) * args[0].shape[1] > split.ROW_GROUP
    ref = _jax_ref(c, tm, lens, table)
    for n in _splits(args[0], Hkv):
        out = split.tree_attention_paged_split(*args, n)[:, :T]
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("T", [16, 20])
@pytest.mark.parametrize("arch", HEADS)
def test_dense_split_matches_jax_ref(arch, T):
    Hq, Hkv = HEADS[arch]
    c, tm, lens, table, _ = _case(2, Hq, Hkv, T, holes=())
    q, ck, cv, tk, tv, tm_t, lens_t = _dense_view(_torch(c, tm, lens, table))
    ref = _jax_ref(c, tm, lens, table, dense=(ck.numpy(), cv.numpy()))
    q, tk, tv, tm_t, _ = ops.pad_tree(q, tk, tv, tm_t)
    for n in _splits(q, Hkv):
        out = split.tree_attention_dense_split(q, ck, cv, tk, tv, tm_t,
                                               lens_t, n)[:, :T]
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("T", [16, 20])
@pytest.mark.parametrize("arch", HEADS)
def test_wrappers_match_jax_ref(arch, T):
    """K1, K4 at window 0 and K2 through their wrappers (the CPU runs the
    plain versions), no row cap left to refuse them."""
    Hq, Hkv = HEADS[arch]
    c, tm, lens, table, q_pos = _case(3, Hq, Hkv, T, holes=())
    args = _torch(c, tm, lens, table)
    ref = _jax_ref(c, tm, lens, table)
    outs = {"K1": ops.tree_attention_paged_bshd(*args),
            "K4": wops.tree_attention_paged_windowed_bshd(
                *args, torch.from_numpy(q_pos), 0),
            "K2": dense_ops.tree_attention_bshd(*_dense_view(args))}
    for what, out in outs.items():
        assert out.shape == (len(LENS), T, Hq, D), what
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL,
                                   err_msg=what)


@pytest.mark.parametrize("T", [16, 20])
@pytest.mark.parametrize("arch", HEADS)
def test_windowed_wrapper_matches_split(arch, T):
    """K4 at a window of 24 (the first splits of the long slot lie wholly
    behind it) against the windowed split's plain version."""
    window = 24
    Hq, Hkv = HEADS[arch]
    c, tm, lens, table, q_pos = _case(4, Hq, Hkv, T)
    args = _torch(c, tm, lens, table)
    qp = torch.from_numpy(q_pos)
    out = wops.tree_attention_paged_windowed_bshd(*args, qp, window)
    padded = _padded(args, T)
    qp_pad = torch.nn.functional.pad(qp, (0, padded[0].shape[1] - T))
    for n in _splits(padded[0], Hkv):
        ref = split.tree_attention_paged_split(*padded, n, qp_pad,
                                               window)[:, :T]
        torch.testing.assert_close(out, ref, **PLAIN_TOL)


def test_planner_counts_row_groups():
    assert split.row_groups(64) == 1 and split.row_groups(65) == 2
    assert [split.row_groups(r) for r in (80, 128, 144)] == [2, 2, 3]
    # a call of at most 64 rows keeps the split it had (one group)
    assert split.plan_split_len(4, 8, 1) == split.plan_split_len(4, 8) == 64
    assert split.plan_split_len(4, 16, 1) == 128
    # B = 4 at T = 16: starcoder2-7b 16 x 3, qwen2.5-32b and chameleon-34b
    # 32 x 2 blocks a split column
    q = lambda Hq: torch.zeros((4, 16, Hq, D))
    assert ops.planned_split_len(q(36), 4) == 64
    assert ops.planned_split_len(q(40), 8) == 128
    assert ops.planned_split_len(q(64), 8) == 128
    assert ops.planned_split_len(q(24), 8) == 64       # minitron-4b: 48


def test_cuda_shape_check_states_every_grid_refusal():
    """The CUDA path refuses, with its reason, what the kernel's dispatch
    refuses: more (b, kv head) pairs or more row groups (of the G*T rows,
    T padded to 8) than the grid's 65535.  Shapes only: meta tensors."""
    meta = lambda *s: torch.empty(s, device="meta")
    cap = split.ROW_GROUP * 65535                  # rows of 65535 groups
    ops.check_cuda_shape(meta(1, 8, cap // 8, 64), 1)
    ops.check_cuda_shape(meta(65535, 16, 1, 64), 1)
    with pytest.raises(ValueError, match="65536 row groups"):
        ops.check_cuda_shape(meta(1, 8, cap // 8 + 8, 64), 1)
    with pytest.raises(ValueError, match="row groups"):     # T=5 pads to 8
        ops.check_cuda_shape(meta(1, 5, cap // 8 + 8, 64), 1)
    with pytest.raises(ValueError, match=r"\(b, kv head\) pairs"):
        ops.check_cuda_shape(meta(65536, 16, 1, 64), 1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda(args, dtype):
    return tuple(a.to("cuda", dtype) if a.is_floating_point() else a.cuda()
                 for a in args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T", [16, 20])
@pytest.mark.parametrize("arch", HEADS)
def test_cuda_kernel_matches_plain_past_64_rows(arch, T, dtype, tol):
    """K1, K4 (window 24) and K2 at the row counts above, head dim 128,
    against their split's plain version at the planner's split; K1 and K4
    with the NULL block NaN, two identical calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Hq, Hkv = HEADS[arch]
    lens = [0, 37, 300, 80]
    c, tm, lens, table, q_pos = _case(5, Hq, Hkv, T, lens=lens,
                                      garbage=np.nan, d=128)
    dt = getattr(torch, dtype)
    args = _cuda(_torch(c, tm, lens, table), dt)
    qp = torch.from_numpy(q_pos).cuda()
    padded = _padded(args, T)
    qp_pad = torch.nn.functional.pad(qp, (0, padded[0].shape[1] - T))
    n = ops.planned_split_len(padded[0], Hkv)
    c2, *_ = _case(5, Hq, Hkv, T, lens=lens, holes=(), garbage=0.0, d=128)
    dargs = _dense_view(_cuda(_torch(c2, tm, lens, table), dt))
    dpad = _dense_view(_padded(_cuda(_torch(c2, tm, lens, table), dt), T))
    cases = {
        "K1": (lambda: ops.tree_attention_paged_bshd(*args),
               split.tree_attention_paged_split(*padded, n)),
        "K4": (lambda: wops.tree_attention_paged_windowed_bshd(*args, qp, 24),
               split.tree_attention_paged_split(*padded, n, qp_pad, 24)),
        "K2": (lambda: dense_ops.tree_attention_bshd(*dargs),
               split.tree_attention_dense_split(*dpad, n)),
    }
    for what, (run, ref) in cases.items():
        out, again = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(out, again), what
        assert torch.isfinite(out).all(), what
        torch.testing.assert_close(out.float(), ref[:, :T].float(),
                                   atol=tol, rtol=tol, msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", HEADS)
def test_cuda_head_subset_is_bitwise_a_call_on_it(arch, dtype):
    """The first 4 query heads of each kv head (64 rows at T = 16: the
    first row group) out of a full call equal a call on those heads alone
    bit for bit, at the full call's split: K1 and K2, head dim 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Hq, Hkv = HEADS[arch]
    G, T, sub = Hq // Hkv, 16, 4
    c, tm, lens, table, _ = _case(6, Hq, Hkv, T, lens=[0, 37, 300, 80],
                                  d=128)
    args = _cuda(_torch(c, tm, lens, table), getattr(torch, dtype))
    B = args[0].shape[0]
    pick = lambda x: x.reshape(B, T, Hkv, G, -1)[:, :, :, :sub].reshape(
        B, T, Hkv * sub, -1).contiguous()
    n = ops.planned_split_len(args[0], Hkv)
    full = ops.tree_attention_paged_bshd(*args, split_len=n)
    part = ops.tree_attention_paged_bshd(pick(args[0]), *args[1:],
                                         split_len=n)
    dargs = _dense_view(args)
    dfull = dense_ops.tree_attention_bshd(*dargs, split_len=n)
    dpart = dense_ops.tree_attention_bshd(pick(dargs[0]), *dargs[1:],
                                          split_len=n)
    torch.cuda.synchronize()
    assert torch.equal(pick(full), part)
    assert torch.equal(pick(dfull), dpart)


@pytest.mark.gpu
@pytest.mark.parametrize("sub", [1, 2])
@pytest.mark.parametrize("arch", HEADS)
def test_cuda_f32_slice_subset_is_bitwise_a_call_on_it(arch, sub):
    """fp32: the first ``sub`` query heads of each kv head (16 or 32 rows
    at T = 16: one or two of a group's four 16-row slices) out of a full
    call equal a call on those heads alone bit for bit, at the full
    call's split: a row's arithmetic never depends on the other rows of
    its group, whatever the warps of the other slices do.  K1 and K2,
    head dim 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Hq, Hkv = HEADS[arch]
    G, T = Hq // Hkv, 16
    c, tm, lens, table, _ = _case(15, Hq, Hkv, T, lens=[0, 37, 300, 80],
                                  d=128)
    args = _cuda(_torch(c, tm, lens, table), torch.float32)
    B = args[0].shape[0]
    pick = lambda x: x.reshape(B, T, Hkv, G, -1)[:, :, :, :sub].reshape(
        B, T, Hkv * sub, -1).contiguous()
    n = ops.planned_split_len(args[0], Hkv)
    full = ops.tree_attention_paged_bshd(*args, split_len=n)
    part = ops.tree_attention_paged_bshd(pick(args[0]), *args[1:],
                                         split_len=n)
    dargs = _dense_view(args)
    dfull = dense_ops.tree_attention_bshd(*dargs, split_len=n)
    dpart = dense_ops.tree_attention_bshd(pick(dargs[0]), *dargs[1:],
                                          split_len=n)
    torch.cuda.synchronize()
    assert torch.equal(pick(full), part)
    assert torch.equal(pick(dfull), dpart)
