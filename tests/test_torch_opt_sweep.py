"""The port's ``pad_q_heads_to=16`` sweep (``scripts/torch_opt_sweep.py``)
against JAX's (``scripts/opt_sweep.py``), on the CPU (every step on the
``meta`` device):

* the port's padding rule pads exactly the archs, to exactly the head
  counts, that JAX's script pads, over JAX's registry (JAX's script is
  run with its ``run_one`` replaced by a recorder), and both sweep the
  same (arch, shape) pairs;
* for each padded arch, every param and draft-param leaf's spec and
  shard shape on the abstract ``pod16x16`` mesh equals JAX's
  (``spec_for_param``, ``NamedSharding.shard_shape``);
* ``model_flops`` and ``analytic_min_bytes`` of each padded config equal
  JAX's at every shape (both count the unpadded heads);
* a padded arch's ``decode_32k`` record is ``ok`` with more argument
  bytes and a lower ``useful_flops_ratio`` than its unpadded record; an
  unpadded arch's opt record equals its baseline record but for the
  times;
* the resume rule: a pair whose record is ``ok`` or ``skip`` is not run
  again, an ``error`` record is.
"""
import dataclasses
import importlib.util
import json
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
try:
    import jax  # noqa: F401
    from jax.sharding import NamedSharding
    from repro.configs import get_config as jax_get_config
    from repro.configs import list_configs as jax_list_configs
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
    from repro.distributed import sharding as jsh
    from repro.launch import hlo_analysis as jhlo
    from repro.launch import specs as jspecs
    from repro.launch.mesh import make_abstract_mesh as jax_mesh
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
POD = ((16, 16), ("data", "model"))
TIMES = ("build_s", "run_s")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _load("torch_opt_sweep")
PADDED = sweep.padded_archs()


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """JAX's script run with ``run_one`` recording (arch, shape, cfg) and
    doing nothing else: {arch: (shapes in order, the cfg it passed)}."""
    import os

    from repro.launch import dryrun as jdryrun

    seen = {}

    def record(arch, shape, multi_pod, out_dir, cfg):
        assert multi_pod is False
        shapes, _ = seen.setdefault(arch, ([], cfg))
        shapes.append(shape)

    mp = pytest.MonkeyPatch()
    mp.setattr(jdryrun, "run_one", record)
    mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    mp.chdir(tmp_path_factory.mktemp("jax_sweep"))
    try:
        runpy.run_path(str(REPO / "scripts" / "opt_sweep.py"))
    finally:
        mp.undo()
    return seen


@needs_jax
def test_padding_rule_picks_jax_archs(jax_sweep):
    assert sorted(jax_sweep) == sorted(sweep.sweep_archs()) == sorted(
        a for a in jax_list_configs() if a != "vicuna-tiny")
    want = {a: cfg.pad_q_heads_to for a, (_, cfg) in jax_sweep.items()}
    got = {a: sweep.opt_config(get_config(a)).pad_q_heads_to
           for a in sweep.sweep_archs()}
    assert got == want
    assert sorted(PADDED) == sorted(a for a, m in want.items() if m)
    for arch, (shapes, cfg) in jax_sweep.items():
        assert shapes == list(INPUT_SHAPES)
        assert sweep.opt_config(get_config(arch)).n_heads_padded == \
            cfg.n_heads_padded


def test_padded_archs_change_the_group_size():
    """Each padded config has more query heads per kv head, and the same
    head dim, as JAX's padded heads are real heads (``init_gqa`` draws
    ``n_heads_padded`` of them)."""
    assert PADDED
    for arch in PADDED:
        cfg = get_config(arch)
        opt = sweep.opt_config(cfg)
        assert opt.n_heads_padded % 16 == 0 < cfg.n_heads % 16
        assert opt.n_heads_padded // opt.n_kv_heads > cfg.q_per_kv
        assert opt.resolved_head_dim == cfg.resolved_head_dim
        wq = specs.param_structs(opt)["groups"][0]["attn"]["wq"]
        assert wq.shape[-1] == opt.n_heads_padded * opt.resolved_head_dim


def _jax_padded(arch):
    return dataclasses.replace(jax_get_config(arch), pad_q_heads_to=16)


@needs_jax
@pytest.mark.parametrize("arch", PADDED)
def test_padded_param_specs_and_shard_shapes_equal_jax(arch):
    cfg = sweep.opt_config(get_config(arch))
    jcfg = _jax_padded(arch)
    pm, jm = make_abstract_mesh(*POD), jax_mesh(*POD)
    hd = cfg.resolved_head_dim
    n = 0
    for port, jtree in ((specs.param_structs(cfg),
                         jspecs.param_structs(jcfg)),
                        (specs.draft_param_structs(cfg),
                         jspecs.draft_param_structs(jcfg))):
        pl = dict(sh.tree_leaves_with_path(port))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            key = tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path)
            assert tuple(pl[key].shape) == tuple(leaf.shape), key
            want = jsh.spec_for_param(path, leaf, jm, head_dim=hd)
            got = sh.spec_for_param(key, pl[key], pm, head_dim=hd)
            assert got == tuple(want), key
            assert sh.shard_shape(pl[key].shape, got, pm) == tuple(
                NamedSharding(jm, want).shard_shape(leaf.shape)), key
            n += 1
    assert n > 0
    # the padded q/o projections shard at head boundaries on the model axis
    wq = specs.param_structs(cfg)["groups"][0]["attn"]["wq"]
    assert sh.spec_for_param(("groups", 0, "attn", "wq"), wq, pm,
                             head_dim=hd)[-1] == "model"


@needs_jax
@pytest.mark.parametrize("arch", PADDED)
def test_padded_model_flops_and_min_bytes_equal_jax(arch):
    cfg, jcfg = sweep.opt_config(get_config(arch)), _jax_padded(arch)
    for name, shp in INPUT_SHAPES.items():
        a = roofline.model_flops(cfg, shp)
        b = jhlo.model_flops(jcfg, JAX_SHAPES[name])
        assert abs(a - b) <= 1e-12 * abs(b), name
        assert a == roofline.model_flops(get_config(arch), shp)
        a = roofline.analytic_min_bytes(cfg, shp, 256, 16)
        b = jhlo.analytic_min_bytes(jcfg, JAX_SHAPES[name], 256, 16)
        assert abs(a - b) <= 1e-12 * abs(b), name


def test_padded_record_costs_more(tmp_path):
    opt = sweep._run_pair(("gemma3-1b", "decode_32k", str(tmp_path / "o")))
    base = dryrun.run_one("gemma3-1b", "decode_32k", "pod16x16",
                          out_dir=str(tmp_path / "b"), verbose=False)
    assert opt["status"] == base["status"] == "ok"
    assert opt["argument_bytes"] > base["argument_bytes"]
    assert opt["useful_flops_ratio"] < base["useful_flops_ratio"]
    assert opt["model_flops_global"] == base["model_flops_global"]
    assert opt["collective_bytes_per_dev"] is None
    # the padded step's K1/K4 calls take 16 query heads over the one kv head
    shapes = [s for name, _, s in _kernel_shapes("gemma3-1b")
              if name.startswith("tree_attention")]
    assert shapes and all(s["Hq"] == 16 and s["Hkv"] == 1 for s in shapes)


def _kernel_shapes(arch):
    from repro_torch.launch.op_cost import OpCounter

    cfg = sweep.opt_config(get_config(arch))
    spec = specs.build_step_spec(cfg, "decode_32k",
                                 dryrun.mesh_for("pod16x16"))
    with OpCounter() as oc:
        spec.fn(*spec.args)
    return oc.kernels


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "chameleon-34b"])
def test_unpadded_opt_record_equals_baseline(arch, tmp_path):
    assert arch not in PADDED
    assert sweep.opt_config(get_config(arch)) == get_config(arch)
    shape = "long_500k" if arch == "rwkv6-1.6b" else "decode_32k"
    opt = sweep._run_pair((arch, shape, str(tmp_path / "o")))
    base = dryrun.run_one(arch, shape, "pod16x16",
                          out_dir=str(tmp_path / "b"), verbose=False)
    assert {k: v for k, v in opt.items() if k not in TIMES} == \
        {k: v for k, v in base.items() if k not in TIMES}


def test_resume_rule(tmp_path, monkeypatch, capsys):
    out = tmp_path / "opt"
    out.mkdir()
    shapes = list(INPUT_SHAPES)
    for shape, status in zip(shapes, ("ok", "skip", "error")):
        (out / f"gemma3-1b__{shape}__pod16x16.json").write_text(json.dumps(
            {"arch": "gemma3-1b", "shape": shape, "status": status}))
    ran = []
    monkeypatch.setattr(sweep, "_run_pair", lambda job: ran.append(job[:2])
                        or {"status": "ok"})
    assert sweep.main(["--arch", "gemma3-1b", "--out-dir", str(out)]) == \
        {"ok": 2, "skip": 0, "error": 0}
    assert ran == [("gemma3-1b", shapes[2]), ("gemma3-1b", shapes[3])]
    assert "done: 2 ok, 0 skip, 0 error" in capsys.readouterr().out
    assert dryrun.recorded(str(out), "gemma3-1b", shapes[1], sweep.MESH)
    assert not dryrun.recorded(str(out), "gemma3-1b", shapes[2], sweep.MESH)
