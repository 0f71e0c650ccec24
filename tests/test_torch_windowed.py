"""The port's windowed paged tree-verify attention (K4) against the JAX
reference.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
these tests hold it against the JAX Pallas kernel
``tree_attention_paged_windowed_bshd`` (interpret mode) and the JAX oracle
``tree_attention_paged_windowed_ref`` on the cases of
``tests/test_attention_template.py``: windows 0, 24 and 64, pool blocks of
16 and 128, ragged lengths, NULL holes below ``cache_len`` and poisoned
NULL blocks, and a case at head dim 256 over one kv head (gemma3-1b's
heads).  Tolerance ``atol = rtol = 2e-5`` (fp32, the two sides sum in
different orders).  At window 0 the plain K4 equals the plain K1 bit for
bit.  The CUDA kernel against the plain version is the ``gpu``-marked
case; it skips without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_windowed.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.attention_template import ops  # noqa: E402
from repro_torch.kernels.attention_template.ref import (  # noqa: E402
    tree_attention_paged_windowed_plain)
from repro_torch.kernels.tree_attention import ops as k1_ops  # noqa: E402
from repro_torch.kernels.tree_attention.kernel import (  # noqa: E402
    tree_attention_paged_plain)

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, lens, T, Hq, Hkv, D, bs, holes=(), fill=None):
    """Random fp32 operands from a numpy seed in the MODEL layout, with
    ascending-id tables covering [0, len + T) per slot, ``holes`` (slot,
    logical block) punched back to NULL, block 0 set to ``fill``, and
    the verify positions ``cache_len + depth``."""
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
    if fill is not None:
        c["pool_k"][0] = fill
        c["pool_v"][0] = fill
    tree = default_tree(T, 2, 3)
    lens = np.asarray(lens, np.int32)
    q_pos = (lens[:, None] + tree.depth[None, :]).astype(np.int32)
    return c, tree.ancestor_mask, lens, table, q_pos


def _port(c, tm, lens, table, q_pos, window):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return ops.tree_attention_paged_windowed_bshd(
        t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
        torch.from_numpy(tm), torch.from_numpy(lens),
        torch.from_numpy(table), torch.from_numpy(q_pos), window).numpy()


def _jax(name, c, tm, lens, table, q_pos, window):
    """The JAX wrapper (``"kernel"``, interpret mode) or oracle
    (``"ref"``, kernel layout), returned in the model layout."""
    import jax.numpy as jnp
    from repro.kernels.attention_template.ops import (
        tree_attention_paged_windowed_bshd)
    from repro.kernels.attention_template.ref import (
        tree_attention_paged_windowed_ref)

    a = {k: jnp.asarray(v) for k, v in c.items()}
    args = (jnp.asarray(tm), jnp.asarray(lens), jnp.asarray(table),
            jnp.asarray(q_pos), jnp.int32(window))
    if name == "kernel":
        o = tree_attention_paged_windowed_bshd(
            a["q"], a["pool_k"], a["pool_v"], a["tree_k"], a["tree_v"],
            *args, interpret=True)
        return np.asarray(o)
    tr = lambda x: x.transpose(0, 2, 1, 3)
    o = tree_attention_paged_windowed_ref(
        tr(a["q"]), a["pool_k"], a["pool_v"], tr(a["tree_k"]),
        tr(a["tree_v"]), *args)
    return np.asarray(o).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("window", [0, 24, 64])
def test_plain_matches_jax_kernel_and_ref(bs, window):
    """Ragged lens (an empty slot, a partial last block) with a NULL hole
    inside the window's reach and one behind it."""
    lens = [37, 0, 120]
    holes = [(2, 0)] if bs == 128 else [(0, 1), (2, 0), (2, 6)]
    case = _case(bs + window, lens, 8, 4, 2, 64, bs, holes=holes)
    out = _port(*case, window)
    np.testing.assert_allclose(out, _jax("kernel", *case, window), **TOL)
    np.testing.assert_allclose(out, _jax("ref", *case, window), **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_head_dim_256_one_kv_head(window):
    """gemma3-1b's heads: 4 query heads over 1 kv head at head dim 256."""
    case = _case(11, [50, 21], 8, 4, 1, 256, 16, holes=[(0, 1)])
    out = _port(*case, window)
    np.testing.assert_allclose(out, _jax("kernel", *case, window), **TOL)
    np.testing.assert_allclose(out, _jax("ref", *case, window), **TOL)


@pytest.mark.parametrize("fill", [1e4, -1e4, np.nan, np.inf, -np.inf])
def test_poisoned_null_block_never_reaches_output(fill):
    """Whatever physical block 0 holds, not one output bit changes: via
    the unallocated tail nor via a hole below cache_len."""
    kw = dict(lens=[40, 70], T=8, Hq=4, Hkv=2, D=64, bs=16,
              holes=[(1, 3)])
    clean = _case(4, **kw, fill=0.0)
    outs = [_port(*clean, 24), _port(*_case(4, **kw, fill=fill), 24)]
    assert np.isfinite(outs[1]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0], _jax("kernel", *clean, 24), **TOL)


@pytest.mark.parametrize("fill", [np.nan, np.inf])
def test_poison_behind_the_window_never_reaches_output(fill):
    """Pool positions at or behind ``cache_len - window`` are excluded by
    selection: poisoning them changes no output bit."""
    window, bs = 24, 16
    c, tm, lens, table, q_pos = _case(5, [40, 70], 8, 4, 2, 64, bs)
    far = dict(c, pool_k=c["pool_k"].copy(), pool_v=c["pool_v"].copy())
    for b, n in enumerate(lens):
        for p in range(0, n - window + 1):
            far["pool_k"][table[b, p // bs], p % bs] = fill
            far["pool_v"][table[b, p // bs], p % bs] = fill
    out = _port(c, tm, lens, table, q_pos, window)
    np.testing.assert_array_equal(
        out, _port(far, tm, lens, table, q_pos, window))


def test_window_0_is_plain_k1_bitwise():
    """A window <= 0 is an exact no-op: the plain K4 equals the plain K1
    bit for bit (the kernels must too; chip_smoke.py checks that)."""
    c, tm, lens, table, q_pos = _case(6, [37, 90], 8, 4, 2, 64, 16,
                                      holes=[(1, 2)])
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm), torch.from_numpy(lens),
            torch.from_numpy(table))
    for w in (0, -1):
        np.testing.assert_array_equal(
            tree_attention_paged_windowed_plain(
                *args, torch.from_numpy(q_pos), w).numpy(),
            tree_attention_paged_plain(*args).numpy())
    np.testing.assert_array_equal(_port(c, tm, lens, table, q_pos, 0),
                                  k1_ops.tree_attention_paged_bshd(*args)
                                  .numpy())


def test_wrapper_pads_T_and_q_pos():
    """T=13 is padded to 16 (q_pos with zeros) around the plain version
    and sliced back; the result matches the unpadded JAX oracle."""
    case = _case(7, [9, 45], 13, 2, 1, 64, 16)
    out = _port(*case, 24)
    assert out.shape == (2, 13, 2, 64)
    np.testing.assert_allclose(out, _jax("ref", *case, 24), **TOL)


def test_wrapper_rejects_bad_q_pos():
    c, tm, lens, table, q_pos = _case(8, [9], 8, 2, 2, 64, 16)
    with pytest.raises(ValueError, match="q_pos"):
        _port(c, tm, lens, table, q_pos[:, :5], 24)


def test_cpu_path_launches_no_kernel():
    """The launch counter counts kernel launches only: the plain version
    on CPU tensors leaves it alone."""
    before = ops.launches
    _port(*_case(9, [5], 8, 2, 2, 64, 16), 24)
    assert ops.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [512, 0])
def test_cuda_kernel_matches_plain(dtype, tol, window):
    """The hand-written kernel against its plain version on the card, at
    gemma3-1b head shapes, ragged lens past the window, holes and a
    poisoned NULL block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    c, tm, lens, table, q_pos = _case(10, [0, 37, 700, 1500], 16, 4, 1, 256,
                                      16, holes=[(2, 20), (3, 0)],
                                      fill=np.nan)
    dt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to("cuda", dt) for k, v in c.items()}
    args = (t["q"], t["pool_k"], t["pool_v"], t["tree_k"], t["tree_v"],
            torch.from_numpy(tm).cuda(), torch.from_numpy(lens).cuda(),
            torch.from_numpy(table).cuda(), torch.from_numpy(q_pos).cuda())
    before = ops.launches
    out = ops.tree_attention_paged_windowed_bshd(*args, window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = tree_attention_paged_windowed_plain(*args, window)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
