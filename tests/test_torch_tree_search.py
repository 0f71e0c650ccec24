"""Tree search of the port against the JAX package (fp32, CPU).

* ``measure_rank_acc`` of Hydra heads and Hydra++ heads (the prefix
  layer) on a synthetic-corpus batch equals JAX's exactly; where a rank
  differs the test names the tied logits that ``torch.topk`` and
  ``jax.lax.top_k`` may order otherwise (ROADMAP §3), and fails on any
  other difference;
* ``grow_trees`` gives JAX's nested trees, node for node, and
  ``expected_accept_length`` / ``select_tree`` pick the same tree, from
  the measured accuracies and from a hand-made table.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import cfg_pair, to_np  # noqa: E402
from repro.core import tree_search as jts  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import tree_search as ts  # noqa: E402
from repro_torch.data.synthetic import MarkovSpec, sample_corpus  # noqa: E402

torch.set_num_threads(2)
HEADS = {"hydra": dict(kind="hydra", n_heads=3, n_mlp_layers=1,
                       prefix_attention=False),
         "hydra++": dict(kind="hydra++", n_heads=3, n_mlp_layers=2,
                         prefix_attention=True)}


@pytest.fixture(scope="module", params=sorted(HEADS))
def measured(request):
    jcfg, cfg = cfg_pair("vicuna-tiny", reduced=False, vocab_size=64,
                         draft=HEADS[request.param])
    key = jax.random.PRNGKey(2)
    jparams = jax_init_params(key, jcfg)
    jdp = jax_init_draft(jax.random.fold_in(key, 1), jcfg)
    params = bridge.params_from_jax(to_np(jparams), cfg, device="cpu")
    dp = bridge.draft_params_from_jax(to_np(jdp), cfg, device="cpu")
    toks = sample_corpus(MarkovSpec(vocab_size=64, seed=0), 4, 40, seed=2)
    want = jts.measure_rank_acc(jparams, jdp, jcfg, jnp.asarray(toks),
                                max_rank=6)
    got = ts.measure_rank_acc(params, dp, cfg, torch.from_numpy(toks),
                              max_rank=6)
    return want, got


def test_measure_rank_acc_matches_jax(measured):
    want, got = measured
    assert got.shape == want.shape == (3, 6)
    diff = np.argwhere(got != want)
    assert not len(diff), (f"rank accuracies differ at (head, rank) "
                           f"{diff.tolist()}: port {got[tuple(diff.T)]} vs "
                           f"JAX {want[tuple(diff.T)]}")
    assert got.sum() > 0


def _acc_table():
    return np.array([[0.6, 0.2, 0.1, 0.05], [0.5, 0.2, 0.1, 0.05],
                     [0.4, 0.2, 0.05, 0.02]])


@pytest.mark.parametrize("source", ["measured", "table"])
def test_grow_and_select_trees_match_jax(measured, source):
    acc = measured[0] if source == "measured" else _acc_table()
    want = jts.grow_trees(acc, n_max=24, max_children=4)
    got = ts.grow_trees(acc, n_max=24, max_children=4)
    assert [t.parents for t in got] == [t.parents for t in want]
    for a, b in zip(got, want):
        assert ts.expected_accept_length(a, acc) == \
            jts.expected_accept_length(b, acc)
    for c1 in (0.0, 0.01, 0.05):
        assert ts.select_tree(got, acc, step_cost_per_node=c1).parents == \
            jts.select_tree(want, acc, step_cost_per_node=c1).parents
