"""K5's split cache sweep in plain PyTorch (``kernels/mla_attention/ref.py
::mla_attention_paged_split``), the decomposition the CUDA kernel runs:
the latent stream in splits of ``split_len`` positions, one partial per
query row and split, the tree partial last, folded in that order by the
tree-verify kernel's merge rule (``kernels/tree_attention/split.py``).

Held here, fp32, at ``atol = rtol = 1e-5`` (only the order of the sums
differs) against the unsplit plain version and against the JAX kernel
``mla_attention_paged_bshd`` in interpret mode, as
``tests/test_torch_mla.py`` runs it: forced splits of one split over the
whole capacity, the planner's and 16; NULL holes below ``cache_len``;
T = 5 and T = 16; pool block sizes 16 and 128 (a split starts inside a
128-position block).  A poisoned NULL block changes no output bit, and
the planner's rule is checked at deepseek-v2-lite's shapes.  The windowed
split version (``q_pos = cache_len + depth``) matches the unsplit plain
version at the same forced splits, windows 1 to past every length,
including splits wholly behind the window, whose empty partial is the
kernel's skip.  The kernel at forced splits is ``tests/test_torch_mla.py``'s
``gpu``-marked case.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_attention_paged_plain, mla_attention_paged_split)
from repro_torch.kernels.tree_attention import split  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
H, R_LAT, R_ROPE = 4, 64, 16


def _case(seed, bs, T, holes=((2, 1),)):
    """fp32 operands from a numpy seed: slot lengths 0, a partial last
    block, several blocks; ascending-id tables, ``holes`` punched back to
    NULL, the NULL block poisoned with NaN."""
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.standard_normal(s, dtype=np.float32)
    lens = [0, bs + 5, 2 * bs + 37]
    M = -(-(max(lens) + T) // bs) + 1
    table = np.zeros((len(lens), M), np.int32)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(n + T) // bs)
        table[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    for b, j in holes:
        table[b, j] = 0
    c = dict(q_lat=f(3, T, H, R_LAT), q_rope=f(3, T, H, R_ROPE),
             pool_lat=f(nxt, bs, R_LAT), pool_rope=f(nxt, bs, R_ROPE),
             tree_lat=f(3, T, R_LAT), tree_rope=f(3, T, R_ROPE),
             tree_mask=default_tree(T, 4, 4).ancestor_mask,
             cache_len=np.asarray(lens, np.int32), block_table=table)
    c["pool_lat"][0] = np.nan
    c["pool_rope"][0] = np.nan
    return c, 1.0 / math.sqrt(R_LAT // 2 + R_ROPE)


def _torch(c):
    return [torch.from_numpy(v) for v in c.values()]


def _jax_kernel(c, scale):
    import jax.numpy as jnp
    from repro.kernels.attention_template.ops import mla_attention_paged_bshd

    return np.asarray(mla_attention_paged_bshd(
        *(jnp.asarray(v) for v in c.values()), scale=scale, interpret=True))


def _splits(c, T):
    """One split over the capacity, the planner's, 16."""
    cap = c["block_table"].shape[1] * c["pool_lat"].shape[1]
    return (-(-cap // 16) * 16,
            split.plan_mla_split_len(3, H, T, R_LAT, R_ROPE), 16)


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("T", [5, 16])
def test_split_matches_plain_and_jax(bs, T):
    c, scale = _case(bs + T, bs, T)
    args = _torch(c)
    plain = mla_attention_paged_plain(*args, scale=scale)
    jax_out = _jax_kernel(c, scale)
    for split_len in _splits(c, T):
        out = mla_attention_paged_split(*args, scale=scale,
                                        split_len=split_len)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, plain, **TOL)
        np.testing.assert_allclose(out.numpy(), jax_out, **TOL)


@pytest.mark.parametrize("fill", [0.0, 1e4, -np.inf])
def test_poisoned_null_block_changes_no_bit(fill):
    c, scale = _case(3, 16, 16, holes=((1, 0), (2, 1)))
    outs = []
    for f in (np.nan, fill):
        cc = dict(c, pool_lat=c["pool_lat"].copy(),
                  pool_rope=c["pool_rope"].copy())
        cc["pool_lat"][0] = f
        cc["pool_rope"][0] = f
        outs.append(mla_attention_paged_split(*_torch(cc), scale=scale,
                                              split_len=32))
    assert torch.equal(outs[0], outs[1])


def test_hole_is_skipped_not_read():
    """A NULL hole below cache_len changes the result (its keys drop)."""
    c, scale = _case(4, 16, 5, holes=())
    holed = dict(c, block_table=c["block_table"].copy())
    holed["block_table"][2, 1] = 0
    a = mla_attention_paged_split(*_torch(c), scale=scale, split_len=16)
    b = mla_attention_paged_split(*_torch(holed), scale=scale, split_len=16)
    assert (a - b).abs().max() > 1e-3


def test_mla_planner():
    """128 at deepseek-v2-lite's verify (16 heads x 16 tree rows, latent
    512 + rope 64, 4 slots): the least multiple of 64 whose partials
    (2 x 256 rows x 512 x 4 bytes) cost no more than the latent reads the
    head packing saves on it ((16 - 4) x 1152 bytes a key)."""
    assert split.plan_mla_split_len(4, 16, 16, 512, 64) == 128
    assert split.plan_mla_split_len(4, 16, 5, 512, 64) == 64
    # no packing to save on at one head: the largest split
    assert split.plan_mla_split_len(4, 1, 16, 512, 64) == 1024
    for args in ((1, 16, 16, 512, 64), (64, 16, 16, 512, 64),
                 (3, H, 5, R_LAT, R_ROPE)):
        n = split.plan_mla_split_len(*args)
        assert n % 64 == 0 and 64 <= n <= 1024


@pytest.mark.parametrize("window", [1, 5, 40, 64, 1000])
@pytest.mark.parametrize("bs,T", [(16, 16), (128, 5)])
def test_windowed_split_matches_plain(window, bs, T):
    """The windowed split version against the unsplit windowed plain
    version at one split, the planner's and 16, ``q_pos = cache_len +
    depth``; at windows under a slot's length the first splits lie wholly
    behind the window (checked), and a window <= 0 is bitwise the
    unwindowed split."""
    c, scale = _case(bs + T + window, bs, T)
    depth = default_tree(T, 4, 4).depth
    q_pos = torch.from_numpy((c["cache_len"][:, None] + depth[None, :])
                             .astype(np.int32))
    args = _torch(c)
    plain = mla_attention_paged_plain(*args, scale=scale, q_pos=q_pos,
                                      window=window)
    assert torch.isfinite(plain).all()
    for split_len in _splits(c, T):
        out = mla_attention_paged_split(*args, scale=scale,
                                        split_len=split_len, q_pos=q_pos,
                                        window=window)
        torch.testing.assert_close(out, plain, **TOL)
    lens = c["cache_len"]
    if window < 16:
        # the last slot's first split of 16 sits wholly behind the window
        assert 16 - 1 <= lens[-1] - window
    for w in (0, -3):
        assert torch.equal(
            mla_attention_paged_split(*args, scale=scale, split_len=16,
                                      q_pos=q_pos, window=w),
            mla_attention_paged_split(*args, scale=scale, split_len=16))


def test_split_behind_the_window_is_skipped():
    """A split wholly behind the window leaves the empty partial: the
    result equals the one with those keys' blocks punched to NULL."""
    c, scale = _case(21, 16, 5, holes=())
    depth = default_tree(5, 4, 4).depth
    q_pos = torch.from_numpy((c["cache_len"][:, None] + depth[None, :])
                             .astype(np.int32))
    window = 20
    out = mla_attention_paged_split(*_torch(c), scale=scale, split_len=16,
                                    q_pos=q_pos, window=window)
    # slot 2 (len 69): positions 0..47 lie at or behind 69 - 20, blocks 0-2
    punched = dict(c, block_table=c["block_table"].copy())
    punched["block_table"][2, :3] = 0
    ref = mla_attention_paged_split(*_torch(punched), scale=scale,
                                    split_len=16, q_pos=q_pos, window=window)
    assert torch.equal(out[2], ref[2])
