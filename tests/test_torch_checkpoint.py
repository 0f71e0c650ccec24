"""Checkpoints shared with the JAX package, and the port's msgpack (CPU).

* the port's ``packb``/``unpackb`` against the real ``msgpack`` on the
  manifest's types (every length class of map, array, str and int):
  the same bytes, and each decodes the other's;
* JAX ``save_checkpoint`` -> port ``load_checkpoint`` and port save -> JAX
  ``load_checkpoint``, bitwise, for base params (vicuna-tiny), Hydra++
  draft params and EAGLE params, fp32; the manifest's treedef equals
  JAX's ``str(treedef)``;
* bf16: the port round-trips its own bf16 leaves bit for bit, and reads
  a bf16 checkpoint JAX wrote (NumPy stores ``ml_dtypes.bfloat16`` as
  two raw bytes an element, which JAX's own loader cannot cast back);
* a mismatched tree is refused.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp  # noqa: E402

from _torch_training import cfg_pair, port_leaves, to_np  # noqa: E402
from repro.core.eagle import init_eagle_params as jax_init_eagle  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.eagle import init_eagle_params  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402

OBJECTS = [
    {"treedef": "PyTreeDef({'a': *})", "n_leaves": 1, "dtypes": ["float32"]},
    {"k" * 40: "v" * 300, "n": 70000, "m": -5, "o": -200, "p": 2 ** 40,
     "q": -40000, "r": "é" * 20},
    {str(i): i for i in range(20)}, ["x"] * 70000, [], {}, "", "y" * 31,
    "y" * 32, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
    -128, -129, -32768, -32769, -2 ** 31 - 1,
]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_msgpack_subset_matches_msgpack(obj):
    b = ckpt.packb(obj)
    assert b == msgpack.packb(obj)
    assert ckpt.unpackb(msgpack.packb(obj)) == obj
    assert msgpack.unpackb(b) == obj


def _trees():
    """(name, JAX tree, port tree of fresh zeros-like params, converter)."""
    jcfg, cfg = cfg_pair("vicuna-tiny", reduced=False,
                         draft=dict(kind="hydra++", n_heads=2, n_mlp_layers=2,
                                    prefix_attention=True))
    key = jax.random.PRNGKey(0)
    out = []
    for name, jt, conv in (
            ("base", jax_init_params(key, jcfg), bridge.params_from_jax),
            ("draft", jax_init_draft(jax.random.fold_in(key, 1), jcfg),
             bridge.draft_params_from_jax),
            ("eagle", jax_init_eagle(jax.random.fold_in(key, 2), jcfg),
             bridge.eagle_params_from_jax)):
        like = conv(to_np(jax.tree_util.tree_map(jnp.zeros_like, jt)), cfg,
                    device="cpu")
        out.append((name, jt, like, conv, cfg))
    return out


@pytest.fixture(scope="module")
def trees():
    return _trees()


def _equal(port_tree, jax_tree):
    got, want = port_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(
            g.view(np.uint32), np.asarray(w, np.float32).view(np.uint32))


@pytest.mark.parametrize("which", [0, 1, 2], ids=["base", "draft", "eagle"])
def test_jax_checkpoint_loads_in_the_port(trees, tmp_path, which):
    name, jt, like, conv, cfg = trees[which]
    path = os.path.join(tmp_path, name)
    jckpt.save_checkpoint(path, jt)
    loaded = ckpt.load_checkpoint(path, like)
    _equal(loaded, jt)
    if name == "base":                  # into port params via the bridge
        params = conv(bridge.to_numpy(loaded), cfg, device="cpu")
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        assert torch.equal(params["unembed_f32"], w)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["base", "draft", "eagle"])
def test_port_checkpoint_loads_in_jax(trees, tmp_path, which):
    name, jt, like, conv, cfg = trees[which]
    port = conv(to_np(jt), cfg, device="cpu")
    path = os.path.join(tmp_path, name)
    ckpt.save_checkpoint(path, port)
    restored = jckpt.load_checkpoint(
        path, jax.tree_util.tree_map(jnp.zeros_like, jt))
    _equal(port, restored)
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    assert meta["treedef"] == str(jax.tree_util.tree_structure(jt))
    assert meta["n_leaves"] == len(jax.tree_util.tree_leaves(jt))
    assert set(meta["dtypes"]) == {"float32"}


def test_bf16_checkpoints(tmp_path):
    cfg = dataclasses.replace(cfg_pair("vicuna-tiny")[1], dtype="bfloat16")
    params = init_params(cfg, seed=3, device="cpu")
    ckpt.save_checkpoint(os.path.join(tmp_path, "p"), params)
    like = init_params(cfg, seed=4, device="cpu")
    back = ckpt.load_checkpoint(os.path.join(tmp_path, "p"), like)
    for a, b in zip(ckpt.tree_leaves(params), ckpt.tree_leaves(back)):
        assert b.dtype == torch.bfloat16 and torch.equal(
            a.view(torch.int16), b.view(torch.int16))
    # a bf16 tree JAX saved, read by its bits
    jt = {"w": jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                           jnp.bfloat16), "b": jnp.ones((4,), jnp.float32)}
    jckpt.save_checkpoint(os.path.join(tmp_path, "j"), jt)
    got = ckpt.load_checkpoint(os.path.join(tmp_path, "j"),
                               {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                                "b": torch.zeros(4)})
    assert np.array_equal(got["w"].float().numpy(),
                          np.asarray(jt["w"], np.float32))
    assert torch.equal(got["b"], torch.ones(4))


def test_mismatched_tree_is_refused(tmp_path):
    ep = init_eagle_params(cfg_pair("vicuna-tiny")[1], device="cpu")
    ckpt.save_checkpoint(str(tmp_path), ep)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_checkpoint(str(tmp_path), {"fc": ep["fc"]})
    bad = dict(ep, fc=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.load_checkpoint(str(tmp_path), bad)
