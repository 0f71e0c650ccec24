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
the planner's rule is checked at deepseek-v2-lite's shapes.  The kernel
at forced splits is ``tests/test_torch_mla.py``'s ``gpu``-marked case.
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
