"""The port's sharding rules and meta structures against the JAX package
(CPU; nothing is allocated on either side: the port's trees live on the
``meta`` device, JAX's come from ``jax.eval_shape``, and its meshes are
``AbstractMesh``es).

* For every leaf of every registry config at full width (params and
  draft params), ``spec_for_param`` equals JAX's on the meshes (1, 1),
  (16, 16) and (2, 16, 16), with ``head_dim`` given and
  ``replicate_ragged_attn`` both ways, and ``shard_shape`` equals
  ``NamedSharding(...).shard_shape``, exactly.
* ``cache_shardings`` and the decode-state specs equal JAX's at B=128
  (decode_32k) and B=1 (long_500k).
* The port's meta params, draft params, AdamW state, caches, decode state
  and batches have JAX's leaf paths, shapes and dtypes.  Named
  differences: the port-only leaf ``unembed_f32`` (the fp32 unembedding,
  ``models/model.py::add_unembed_f32``), the decode state's ``rng``
  (JAX's key; the port samples from a ``torch.Generator``) and its
  ``last_token`` dtype (int64, the port's index type; JAX int32).
* The port's rules alone: ``unembed_f32`` takes ``unembed``'s rule, and a
  one-name tuple is written as the name, as JAX's ``PartitionSpec``
  writes it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import get_config as jax_get_config
    from repro.distributed import sharding as jsh
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_abstract_mesh as jax_mesh
    from repro.training.optim import init_adamw as jax_init_adamw
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import (make_abstract_mesh,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.training.optim import init_adamw  # noqa: E402

MESHES = (((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
ARCHS = list_configs()
DECODERS = [a for a in ARCHS if get_config(a).supports_decode]
EXTRA = {("unembed_f32",)}           # the port-only leaf


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree, paths in the port's form."""
    return {tuple(_key(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return dict(sh.tree_leaves_with_path(tree))


def _jdtype(dt) -> str:
    return np.dtype(dt).name


def _same_structs(port, jx, extra=frozenset(), dtypes=None):
    """The port's tree has JAX's leaf paths (plus ``extra``), shapes and
    dtypes (``dtypes``: {path: the port's dtype} where they differ)."""
    pl, jl = _port_leaves(port), _jax_leaves(jx)
    assert set(pl) == set(jl) | set(extra), (
        set(pl) ^ (set(jl) | set(extra)))
    for path, leaf in jl.items():
        t = pl[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(leaf.shape), path
        want = (dtypes or {}).get(path, _jdtype(leaf.dtype))
        assert str(t.dtype).removeprefix("torch.") == want, path


def _spec_tuple(p) -> tuple:
    return tuple(p)


@pytest.fixture(scope="module")
def jax_structs():
    """{arch: (params, draft params)} from ``jax.eval_shape``."""
    return {a: (jspecs.param_structs(jax_get_config(a)),
                jspecs.draft_param_structs(jax_get_config(a)))
            for a in ARCHS} if jax is not None else None


@pytest.fixture(scope="module")
def port_structs():
    """{arch: (params, draft params)} on ``meta``, made once."""
    return {a: (specs.param_structs(get_config(a)),
                specs.draft_param_structs(get_config(a))) for a in ARCHS}


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shard_shapes_equal_jax(arch, jax_structs,
                                                port_structs):
    cfg = get_config(arch)
    port = dict(zip(("params", "draft"), port_structs[arch]))
    jtrees = dict(zip(("params", "draft"), jax_structs[arch]))
    n = 0
    for shape, axes in MESHES:
        pm, jm = make_abstract_mesh(shape, axes), jax_mesh(shape, axes)
        for ragged in (False, True):
            for which in ("params", "draft"):
                pl = _port_leaves(port[which])
                jl = jax.tree_util.tree_flatten_with_path(jtrees[which])[0]
                assert set(pl) == ({tuple(_key(k) for k in p) for p, _ in jl}
                                   | (EXTRA if which == "params" else set()))
                for path, leaf in jl:
                    key = tuple(_key(k) for k in path)
                    want = jsh.spec_for_param(
                        path, leaf, jm, head_dim=cfg.resolved_head_dim,
                        replicate_ragged_attn=ragged)
                    got = sh.spec_for_param(
                        key, pl[key], pm, head_dim=cfg.resolved_head_dim,
                        replicate_ragged_attn=ragged)
                    assert got == _spec_tuple(want), (key, shape, ragged)
                    assert sh.shard_shape(pl[key].shape, got, pm) == tuple(
                        NamedSharding(jm, want).shard_shape(leaf.shape)), key
                    n += 1
    assert n > 0
    # the port-only leaf takes unembed's rule
    u = port["params"]["unembed_f32"]
    for shape, axes in MESHES:
        pm = make_abstract_mesh(shape, axes)
        assert sh.spec_for_param(("unembed_f32",), u, pm) == \
            sh.spec_for_param(("heads", 0, "unembed"), u, pm)


@needs_jax
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_and_decode_state_specs_equal_jax(arch, shape_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shp = INPUT_SHAPES[shape_name]
    B, max_len = shp.global_batch, shp.seq_len + 64
    with_prefix = cfg.draft.prefix_attention
    port = specs.decode_state_structs(cfg, B, max_len, with_prefix)
    jstate = jspecs.decode_state_structs(jcfg, B, max_len, with_prefix)
    for shape, axes in MESHES:
        pm, jm = make_abstract_mesh(shape, axes), jax_mesh(shape, axes)
        got = specs.decode_state_shardings(cfg, pm, port, B)
        want = jspecs.decode_state_shardings(jcfg, jm, jstate, B)
        gl = dict(sh.tree_leaves_with_path(got, specs=True))
        wl = {p: _spec_tuple(s.spec) for p, s in _jax_leaves(want).items()}
        assert set(gl) == set(wl) - {("rng",)}, set(gl) ^ set(wl)
        for path, s in wl.items():
            if path != ("rng",):
                assert gl[path] == s, (path, shape)
        # cache_shardings alone, and the shard shapes it implies
        got_c = sh.cache_shardings(port.cache, pm, B)
        want_c = jsh.cache_shardings(jstate.cache, jm, B)
        leaves = _port_leaves(port.cache)
        for path, s in _jax_leaves(want_c).items():
            g = dict(sh.tree_leaves_with_path(got_c, specs=True))[path]
            assert g == _spec_tuple(s.spec), path
            assert sh.shard_shape(leaves[path].shape, g, pm) == tuple(
                s.shard_shape(leaves[path].shape)), path


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_structures_equal_jax_eval_shape(arch, jax_structs,
                                             port_structs):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jp, jd = jax_structs[arch]
    pp, pd = port_structs[arch]
    _same_structs(pp, jp, extra=EXTRA)
    _same_structs(pd, jd)
    jopt = jax.eval_shape(jax_init_adamw, jp)
    opt = init_adamw(pp)
    assert opt.step.device.type == "meta"
    assert tuple(opt.step.shape) == jopt.step.shape
    assert str(opt.step.dtype).removeprefix("torch.") == \
        _jdtype(jopt.step.dtype)
    _same_structs(opt.mu, jopt.mu)
    _same_structs(opt.nu, jopt.nu)
    for B, S in ((2, 64), (1, 33)):
        _same_structs(specs.batch_structs(cfg, B, S),
                      jspecs.batch_structs(jcfg, B, S))
    if cfg.supports_decode:
        with_prefix = "prefix" in pd
        port = specs.decode_state_structs(cfg, 4, 512, with_prefix)
        js = jspecs.decode_state_structs(jcfg, 4, 512, with_prefix)
        jl = _jax_leaves(js)
        assert jl.pop(("rng",)) is not None
        _same_structs(port, {"cache": js.cache, "cache_len": js.cache_len,
                             "last_token": js.last_token,
                             "last_hidden": js.last_hidden,
                             **({"prefix_k": js.prefix_k,
                                 "prefix_v": js.prefix_v}
                                if with_prefix else {})},
                      dtypes={("last_token",): "int64"})
        assert set(_port_leaves(port)) == set(jl)


def test_meta_init_draws_nothing_and_cpu_draws_as_before():
    """On ``meta`` the inits take no generator and give meta tensors; on
    the CPU they draw what they drew (two calls, one seed: equal)."""
    from repro_torch.core.eagle import init_eagle_params
    from repro_torch.core.heads import init_draft_params
    from repro_torch.models.model import init_params

    cfg = get_config("vicuna-tiny")
    for init in (init_params, init_draft_params, init_eagle_params):
        meta = init(cfg, device="meta")
        assert all(t.device.type == "meta"
                   for _, t in sh.tree_leaves_with_path(meta))
        a, b = init(cfg, seed=3, device="cpu"), init(cfg, seed=3, device="cpu")
        la, lb = _port_leaves(a), _port_leaves(b)
        assert set(la) == set(_port_leaves(meta))
        for path, t in la.items():
            assert torch.equal(t, lb[path]), path


def test_port_rules_alone():
    host, pod = make_host_mesh(), make_production_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    assert make_production_mesh(multi_pod=True).size == 512
    w = torch.empty((2048, 262144), device="meta")
    assert sh.spec_for_param(("unembed_f32",), w, pod) == (None, "model")
    assert sh.shard_shape(w.shape, (None, "model"), pod) == (2048, 16384)
    # batch: ('pod', 'data') stays a tuple, ('data',) is written 'data'
    assert sh.tokens_sharding(make_production_mesh(multi_pod=True), 64) \
        == (("pod", "data"), None)
    assert sh.tokens_sharding(pod, 32) == ("data", None)
    assert sh.tokens_sharding(pod, 1) == (None, None)
    with pytest.raises(ValueError):
        sh.shard_shape((3, 4), ("data", None), pod)
    # a ragged kv projection replicates; an unknown leaf replicates
    wk = torch.empty((3, 2048, 3 * 128), device="meta")
    assert sh.spec_for_param(("groups", 0, "attn", "wk"), wk, pod,
                             head_dim=128) == ()
    assert sh.spec_for_param(("groups", 0, "mamba", "conv_w"), wk,
                             pod) == ()
