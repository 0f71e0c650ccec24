"""Shared helpers of the training-slice parity tests (the port against
the JAX package, fp32, on the CPU): config pairs, param conversion and
the per-leaf comparisons."""
import dataclasses

import numpy as np
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.training.pytree import tree_leaves


def cfg_pair(name: str, *, reduced: bool = True, **kw):
    """(JAX config, port config) of ``name`` in fp32 (``reduced()``
    unless ``reduced=False``), with ``kw`` replaced in both; a ``draft``
    dict replaces fields of the draft config."""
    draft = kw.pop("draft", None)
    out = []
    for get in (jax_get_config, get_config):
        c = get(name)
        c = c.reduced() if reduced else c
        c = dataclasses.replace(c, dtype="float32", **kw)
        if draft:
            c = dataclasses.replace(c, draft=dataclasses.replace(c.draft,
                                                                 **draft))
        out.append(c)
    return out


def to_np(tree):
    """A JAX tree as numpy leaves (the bridge's input)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def port_leaves(tree) -> list:
    """A port tree's leaves in JAX's order, as fp32 numpy."""
    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_trees_close(port_tree, jax_tree, rel: float, what: str) -> float:
    """Every leaf within relative L2 ``rel`` of JAX's (a zero JAX leaf
    must be zero); returns the largest relative error."""
    got, want = port_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want), f"{what}: {len(got)} != {len(want)} leaves"
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, f"{what} leaf {i}: {g.shape} != {w.shape}"
        if not np.any(w):
            assert not np.any(g), f"{what} leaf {i}: JAX's is zero"
            continue
        err = rel_l2(g, w)
        worst = max(worst, err)
        assert err <= rel, f"{what} leaf {i}: relative L2 {err:.3e} > {rel}"
    return worst


def tokens(seed: int, B: int, S: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))
