"""``examples/torch_train_hydra_pp.py``, the port of the paper's training
example, on the CPU at a few steps: a base model, then Medusa, Hydra and
Hydra++ heads trained, checkpointed under ``CKPT`` (here a temporary
directory) and evaluated (three rows of mean accepted length); a second
run restores every checkpoint instead of training and prints the same
rows; without ``--device cpu`` and without a card it raises."""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(2)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "torch_train_hydra_pp.py"


@pytest.fixture
def example(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location("torch_train_hydra_pp",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "CKPT", str(tmp_path / "ckpt"))
    return mod


def _rows(out: str) -> dict:
    return {m[0]: (float(m[1]), int(m[2])) for m in re.findall(
        r"^(medusa|hydra\+\+|hydra) +([\d.]+) +(\d+)$", out, re.M)}


def test_example_trains_checkpoints_and_restores(example, capsys, tmp_path):
    argv = ["--base-steps", "3", "--head-steps", "3", "--device", "cpu"]
    first = example.main(argv)
    out = capsys.readouterr().out
    assert list(_rows(out)) == ["medusa", "hydra", "hydra++"]
    assert "restored" not in out
    for name, (acc, steps) in first.items():
        assert acc >= 1.0 and steps > 0
        assert _rows(out)[name] == (round(acc, 3), steps)
    saved = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert saved == ["base", "heads_hydra", "heads_hydra++", "heads_medusa"]
    again = example.main(argv)
    out = capsys.readouterr().out
    assert "base: restored from checkpoint" in out
    assert "[base" not in out and "[heads" not in out
    assert again == first


def test_example_needs_a_card_unless_asked_for_the_cpu(example,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main(["--base-steps", "1", "--head-steps", "1"])
