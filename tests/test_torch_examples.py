"""The port's three serving examples on the CPU at a few steps:
``examples/torch_quickstart.py`` (base and Hydra heads trained, then
speculative against autoregressive decoding), ``examples/
torch_serve_spec.py`` (AR, Medusa, Hydra and Hydra++ through the
continuous, paged and bucketed engines; the three engines' greedy
streams equal in each mode) and ``examples/torch_tree_search.py`` (rank
acceptance, tree growth, the throughput sweep over four trees).  The
last two train through ``repro_torch.training.tiny``, whose checkpoints
go to a temporary directory here; a second run restores them instead of
training and gives the same results.  Without ``--device cpu`` and
without a card each example raises."""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.training import tiny  # noqa: E402

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SERVE_ARGV = ["--batch", "2", "--requests", "4", "--max-new-tokens", "8",
              "--device", "cpu"]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ckpt(tmp_path, monkeypatch):
    """``tiny``'s checkpoints in a temporary directory, 3 training steps."""
    monkeypatch.setattr(tiny, "CKPT_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setattr(tiny, "BASE_STEPS", 3)
    monkeypatch.setattr(tiny, "HEAD_STEPS", 3)
    return tmp_path / "ckpt"


def test_quickstart(capsys):
    out = _load("torch_quickstart").main(["--steps", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    for stage in ("== 1.", "== 2.", "== 3."):
        assert stage in text
    assert out["spec_steps"] > 0 and out["ar_steps"] > 0
    assert out["spec_steps"] <= out["ar_steps"]
    assert out["accept_len"] >= 1.0
    assert f"speculative: {out['spec_steps']} steps" in text
    assert f"autoregressive: {out['ar_steps']} steps" in text
    # greedy speculative decoding reproduces the base model's own output
    assert out["same"] and "greedy outputs identical: True" in text


def _rows(text: str) -> list:
    return re.findall(r"^(autoregressive|medusa|hydra\+\+|hydra) +"
                      r"(continuous|paged|bucketed) +steps=", text, re.M)


def test_serve_spec_engines_agree_and_restore(ckpt, capsys):
    mod = _load("torch_serve_spec")
    first = mod.main(SERVE_ARGV)
    text = capsys.readouterr().out
    assert _rows(text) == [(m, e) for m in mod.MODES for e in mod.ENGINES]
    assert "restored" not in text.split("autoregressive")[0]
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "base_tiny", "heads_hydra++_distill", "heads_hydra_data",
        "heads_medusa_data"]
    for mode in mod.MODES:
        streams = [first[(mode, e)][1] for e in mod.ENGINES]
        assert all(len(s) == 4 and all(s) for s in streams)
        assert streams[1] == streams[0] and streams[2] == streams[0], mode
        assert f"{mode:16s} greedy streams equal across engines: True" in text
    stats = first[("hydra", "paged")][0]
    assert stats.pool_tokens == 16 * ((2 * 512 // 4) // 16)
    again = mod.main(SERVE_ARGV)
    text = capsys.readouterr().out
    assert "base_tiny: restored from checkpoint" in text
    assert "heads_hydra++_distill: restored from checkpoint" in text
    assert "[base" not in text and "[heads" not in text
    assert {k: v[1] for k, v in again.items()} == \
        {k: v[1] for k, v in first.items()}


def test_tree_search_restores(ckpt, capsys):
    mod = _load("torch_tree_search")
    first = mod.main(["--device", "cpu"])
    text = capsys.readouterr().out
    for stage in ("stage 1", "stage 2", "stage 3"):
        assert stage in text
    assert len(re.findall(r"^  head \d: ", text, re.M)) == 4
    assert sorted(first["tok_s"]) == [5, 9, 17, 33]
    assert all(t > 0 for t in first["tok_s"].values())
    assert first["selected"] in first["tok_s"]
    assert f"selected tree size: {first['selected']}" in text
    again = mod.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "heads_hydra_data: restored from checkpoint" in text
    assert "[base" not in text and "[heads" not in text
    assert again["accept"] == first["accept"]


@pytest.mark.parametrize("name,argv", [
    ("torch_quickstart", ["--steps", "1"]),
    ("torch_serve_spec", ["--requests", "1"]),
    ("torch_tree_search", [])])
def test_examples_need_a_card_unless_asked_for_the_cpu(name, argv, ckpt,
                                                       monkeypatch):
    mod = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not ckpt.exists()
