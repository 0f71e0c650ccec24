"""The port's dry run (``launch/dryrun.py``) and roofline arithmetic
(``launch/roofline.py``) against the JAX package (CPU; the step runs on
the ``meta`` device, so nothing is allocated and no card is needed).

* The status of every (arch, shape) pair equals JAX's ``skip_reason``,
  reason for reason.
* ``model_flops`` and ``analytic_min_bytes`` equal JAX's for every
  arch x shape x mesh (the host's 1 x 1 and the pods' 16 x 16 and
  2 x 16 x 16), to relative 1e-12.
* A record on the host mesh: argument bytes are the meta arguments'
  bytes, the roofline terms come from the counter (compute from its
  least operations time, memory from its bytes), the scope is the
  device's; on a pod mesh the scope is global, the per-device terms are
  the analytic ones and the argument bytes are the shard shapes'.
* The CLI: ``--arch vicuna-tiny --host`` writes a record per shape,
  ``--skip-done`` runs nothing again, ``--jobs 2`` gives the same
  records.
"""
import json

import pytest

torch = pytest.importorskip("torch")
try:
    import jax  # noqa: F401
    from repro.configs import get_config as jax_get_config
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
    from repro.launch import hlo_analysis as jhlo
    from repro.launch.specs import skip_reason as jax_skip_reason
except ImportError:
    jax_get_config = None
needs_jax = pytest.mark.skipif(jax_get_config is None,
                               reason="needs JAX, the reference")

from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402
from repro_torch.launch.specs import build_step_spec, skip_reason  # noqa: E402

ARCHS = [a for a in list_configs() if a != "vicuna-tiny"]
MESHES = (("host1x1", 1, 1), ("pod16x16", 256, 16), ("pod2x16x16", 512, 16))


@needs_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_status_per_pair_equals_jax(arch, tmp_path):
    for shape in INPUT_SHAPES:
        want = jax_skip_reason(jax_get_config(arch), shape)
        assert skip_reason(get_config(arch), shape) == want
        if want:
            rec = dryrun.run_one(arch, shape, out_dir=str(tmp_path),
                                 verbose=False)
            assert rec["status"] == "skip" and rec["reason"] == want


@needs_jax
@pytest.mark.parametrize("arch", ARCHS + ["vicuna-tiny"])
def test_model_flops_and_min_bytes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shp in INPUT_SHAPES.items():
        jshp = JAX_SHAPES[name]
        a, b = roofline.model_flops(cfg, shp), jhlo.model_flops(jcfg, jshp)
        assert abs(a - b) <= 1e-12 * abs(b), name
        for _, n_chips, mp in MESHES:
            a = roofline.analytic_min_bytes(cfg, shp, n_chips, mp)
            b = jhlo.analytic_min_bytes(jcfg, jshp, n_chips, mp)
            assert abs(a - b) <= 1e-12 * abs(b), (name, n_chips)


def _nbytes(tree) -> int:
    from repro_torch.distributed.sharding import tree_leaves_with_path

    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves_with_path(tree))


def test_host_record(tmp_path):
    rec = dryrun.run_one("gemma3-1b", "decode_32k", "host1x1",
                         out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok" and rec["scope"] == "device"
    cfg = get_config("gemma3-1b")
    spec = build_step_spec(cfg, "decode_32k", dryrun.mesh_for("host1x1"))
    assert rec["argument_bytes"] == _nbytes(spec.args)
    assert rec["memory_s"] == rec["counted_bytes"] / HBM_BW
    assert rec["compute_s"] == rec["counted_compute_s"]
    assert rec["bottleneck"] == max(("compute_s", "memory_s"),
                                    key=lambda k: rec[k])
    # K2 on the 4 global layers and the prefix layer (the windowed layers
    # of the dense cache run the plain masked attention, as in JAX)
    assert rec["kernels"]["tree_attention_dense"]["calls"] == 5
    assert set(rec["flops_by_dtype"]) == {"bfloat16", "float32"}
    assert rec["model_flops_global"] == roofline.model_flops(
        cfg, INPUT_SHAPES["decode_32k"])
    assert rec["collective_bytes_per_dev"] is None
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    saved = json.loads((tmp_path / "gemma3-1b__decode_32k__host1x1.json")
                       .read_text())
    assert saved["counted_bytes"] == rec["counted_bytes"]


def test_pod_record_is_global_with_analytic_terms(tmp_path):
    rec = dryrun.run_one("minitron-4b", "decode_32k", "pod16x16",
                         out_dir=str(tmp_path), verbose=False)
    host = dryrun.run_one("minitron-4b", "decode_32k", "host1x1",
                          out_dir=str(tmp_path), verbose=False)
    assert rec["scope"] == "global" and rec["n_chips"] == 256
    cfg, shp = get_config("minitron-4b"), INPUT_SHAPES["decode_32k"]
    assert rec["compute_s"] == (roofline.model_flops(cfg, shp) / 256
                                / PEAK_FLOPS_BF16)
    assert rec["memory_s"] == roofline.analytic_min_bytes(
        cfg, shp, 256, 16) / HBM_BW
    # the counted whole step is the host's; the arguments are sharded
    assert rec["counted_bytes"] == host["counted_bytes"]
    assert rec["argument_bytes"] < host["argument_bytes"] / 16
    assert rec["peak_bytes"] is None


def test_cli(tmp_path, capsys):
    out = str(tmp_path / "a")
    dryrun.main(["--arch", "vicuna-tiny", "--host", "--out-dir", out])
    recs = {p.name: json.loads(p.read_text())
            for p in (tmp_path / "a").iterdir()}
    assert sorted(recs) == sorted(f"vicuna-tiny__{s}__host1x1.json"
                                  for s in INPUT_SHAPES)
    assert [r["status"] for r in recs.values()].count("skip") == 1
    assert "done: 3 ok, 1 skip, 0 error" in capsys.readouterr().out
    dryrun.main(["--arch", "vicuna-tiny", "--host", "--out-dir", out,
                 "--skip-done"])
    assert "done: 0 ok, 0 skip, 0 error" in capsys.readouterr().out
    out2 = str(tmp_path / "b")
    dryrun.main(["--arch", "vicuna-tiny", "--host", "--out-dir", out2,
                 "--jobs", "2"])
    for name, r in recs.items():
        r2 = json.loads((tmp_path / "b" / name).read_text())
        for key in ("status", "flops_by_dtype", "counted_bytes",
                    "peak_live_bytes", "argument_bytes", "kernels"):
            assert r2.get(key) == r.get(key), (name, key)
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--host", "--multi-pod"])
