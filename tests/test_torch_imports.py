"""Boundaries of the PyTorch port.

* ``src/repro_torch`` (and ``chip_smoke.py``, the port's examples,
  ``examples/torch_*.py``, and its scripts, ``scripts/torch_*.py``)
  imports neither JAX nor anything of the JAX package ``repro`` (it
  keeps its own copies of the JAX-free modules);
* its entry points (serving, and training's: EAGLE's params, the train
  launcher) run on CUDA by default and raise where CUDA is missing,
  unless the caller passes ``device="cpu"``: they never slip onto the
  CPU;
* the dry-run tools (``distributed/sharding.py``, ``launch/{mesh,specs,
  op_cost,roofline,dryrun}.py``) need no card at all: they run on the
  ``meta`` device, and ``device="meta"`` is asked for explicitly;
* ``chip_smoke.py`` exits non-zero without a result line where CUDA is
  missing.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.eagle import init_eagle_params  # noqa: E402
from repro_torch.core.heads import init_draft_params  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import (dryrun, mesh, op_cost, roofline,  # noqa: E402
                                serve, specs, train)
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.engine import (PagedSpeculativeEngine,  # noqa: E402
                                        SpeculativeEngine)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))
    + sorted((REPO / "scripts").glob("torch_*.py")),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def tiny():
    cfg = get_config("minitron-4b").reduced()
    return cfg, init_params(cfg, device="cpu")


def test_entry_points_refuse_the_cpu_without_asking(monkeypatch, tiny):
    cfg, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: resolve_device(),
        lambda: init_params(cfg),
        lambda: init_draft_params(cfg),
        lambda: bridge.params_from_jax(bridge.to_numpy(params), cfg),
        lambda: SpeculativeEngine(params, None, cfg, tree_for(cfg)),
        lambda: PagedSpeculativeEngine(params, None, cfg, tree_for(cfg)),
        lambda: serve.main(["--arch", "minitron-4b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_training_entry_points_refuse_the_cpu_without_asking(monkeypatch,
                                                             tiny):
    """The training slice's entry points (EAGLE, the train launcher) hold
    the same rule; the others run on their operands' device."""
    cfg, params = tiny
    ep = init_eagle_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: init_eagle_params(cfg),
        lambda: bridge.eagle_params_from_jax(bridge.to_numpy(ep), cfg),
        lambda: train.main(["--arch", "vicuna-tiny", "--steps", "1"]),
        lambda: train.main(["--arch", "hubert-xlarge", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tuning_and_example_entry_points_refuse_the_cpu_without_asking(
        monkeypatch, tmp_path):
    """The autotuner's sweep and the examples' substrate
    (``training/tiny.py``) hold the same rule; ``check`` only reads a
    file and runs anywhere."""
    from repro_torch.kernels import autotune
    from repro_torch.training import tiny

    monkeypatch.setattr(tiny, "CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: autotune.main(["sweep", "--out", str(tmp_path / "a.json")]),
        lambda: autotune.sweep_entry("flash", {
            "dqk": 64, "dv": 64, "hq": 4, "hkv": 2, "causal": 1}),
        lambda: tiny.base_setup(),
        lambda: tiny.draft_setup("hydra"),
        lambda: tiny.eval_prompts(1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "ckpt").exists()
    assert not (tmp_path / "a.json").exists()
    assert autotune.main(["check"]) == 0


def test_rwkv6_entry_points_refuse_the_cpu_without_asking(monkeypatch):
    """The recurrent slice's entry points hold the same rule."""
    cfg = get_config("rwkv6-1.6b").reduced()
    params = init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: init_params(cfg),
        lambda: init_draft_params(cfg),
        lambda: SpeculativeEngine(params, None, cfg, tree_for(cfg)),
        lambda: PagedSpeculativeEngine(params, None, cfg, tree_for(cfg)),
        lambda: serve.main(["--arch", "rwkv6-1.6b"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_dry_run_needs_no_card(monkeypatch, tmp_path, capsys):
    """The dry run and its meta structures run with CUDA missing: every
    tensor lies on ``meta``, nothing on the CPU or a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("minitron-4b")
    assert init_params(cfg, device="meta")["embed"].is_meta
    assert init_draft_params(cfg, device="meta")["heads"][0]["w_in"].is_meta
    spec = specs.build_step_spec(cfg, "decode_32k", mesh.make_host_mesh())
    assert all(t.is_meta for _, t in sharding.tree_leaves_with_path(
        spec.args))
    dryrun.main(["--arch", "minitron-4b", "--shape", "decode_32k", "--host",
                 "--out-dir", str(tmp_path)])
    assert "done: 1 ok, 0 skip, 0 error" in capsys.readouterr().out
    assert roofline.roofline_terms(1.0, 0.0)["bottleneck"] == "compute_s"
    assert op_cost.OpCounter().peak_live_bytes == 0


def test_entry_points_run_on_the_cpu_when_asked(tiny):
    cfg, params = tiny
    assert resolve_device("cpu").type == "cpu"
    back = bridge.params_from_jax(bridge.to_numpy(params), cfg, "cpu")
    np.testing.assert_array_equal(back["embed"].float().numpy(),
                                  params["embed"].float().numpy())
    eng = PagedSpeculativeEngine(params, None, cfg, tree_for(cfg),
                                 device="cpu")
    assert eng.device.type == "cpu"


def test_engine_rejects_params_on_another_device(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="params lie on"):
        SpeculativeEngine(params, None, cfg, tree_for(cfg), device="meta")


@pytest.mark.parametrize("engine,extra", [("paged", ["--ragged"]),
                                          ("continuous", ["--profile"])])
def test_serve_launcher_on_the_cpu(capsys, engine, extra):
    serve.main(["--arch", "minitron-4b", "--engine", engine, "--batch", "2",
                "--requests", "3", "--prompt-len", "12",
                "--max-new-tokens", "5", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert f"[serve] engine={engine} " in out and "tokens=12 " in out
    if "--profile" in extra:
        assert "[profile] device busy" in out


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """No card (CUDA hidden), or the script without the repository
    beside it: a non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
