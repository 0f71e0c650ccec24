"""``training/tiny.py::train_tiny`` and ``scripts/torch_train_tiny.py``,
the port of JAX's ``scripts/train_tiny.py`` (CPU, fp32):

* the recipe's values (config, corpus, pipeline, training schedule,
  seeds, draft variants, tree, prompts, budgets, checkpoint names) equal
  JAX's script's, read from it with ``ast`` (importing it would run it)
  and from what ``train_tiny`` actually passes;
* ``train_tiny(steps=2, device="cpu", ckpt_dir=tmp)`` writes
  ``base_tiny`` and ``heads_{medusa,hydra}_tiny``, and JAX's
  ``load_checkpoint`` restores each into JAX-initialised trees bit for
  bit equal to the trees ``train_tiny`` trained;
* on those restored params JAX's ``generate`` and the port's give equal
  greedy token streams, steps and acceptance lengths on the script's 4
  prompts of 32 tokens, 48 new tokens, ``default_tree(16, 4, 4)``;
* afterwards ``base_setup(device="cpu")`` restores that base instead of
  training its own;
* without a card and without ``device="cpu"`` it raises and writes
  nothing; the script's CLI runs the same recipe.
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import port_leaves  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import DraftConfig as JaxDraftConfig  # noqa: E402
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.core.trees import default_tree as jax_default_tree  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro_torch.core.speculative import PAD_TOKEN, generate  # noqa: E402
from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.training import tiny  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
STEPS = 2


def _literal(node):
    try:
        return ast.literal_eval(node)
    except ValueError:
        return ast.unparse(node)


def _jax_calls() -> dict:
    """{callee name: [(positional args, keyword args)]} of every call in
    JAX's script, literals evaluated (other expressions as source)."""
    calls = {}
    tree = ast.parse((REPO / "scripts" / "train_tiny.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            calls.setdefault(name, []).append((
                [_literal(a) for a in node.args],
                {k.arg: _literal(k.value) for k in node.keywords}))
    return calls


def _jax_loop_kinds() -> list:
    tree = ast.parse((REPO / "scripts" / "train_tiny.py").read_text())
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For))
    return ast.literal_eval(loop.iter)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """``train_tiny(steps=2)`` on the CPU into a temporary directory, with
    the keyword arguments it passed to the recipe's constructors and
    calls recorded."""
    seen = {}
    mp = pytest.MonkeyPatch()

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            seen.setdefault(name, []).append((a, kw))
            return fn(*a, **kw)

        mp.setattr(module, name, wrapped)

    import repro_torch.core.speculative as spec_mod

    for name in ("MarkovSpec", "DataPipeline", "TrainConfig", "init_params", "init_draft_params", "train_heads",
                 "save_checkpoint"):
        spy(tiny, name)
    spy(spec_mod, "generate")
    ckpt = tmp_path_factory.mktemp("ckpt")
    try:
        run = tiny.train_tiny(STEPS, ckpt_dir=str(ckpt), device="cpu",
                              log=lambda s: None)
    finally:
        mp.undo()
    return run, seen, ckpt


def test_recipe_values_equal_jax_script(recorded):
    run, seen, _ = recorded
    calls = _jax_calls()
    assert calls["get_config"] == [(["vicuna-tiny"], {})]
    assert run.cfg.name == "vicuna-tiny" and run.cfg.dtype == "float32"
    assert "dtype='float32'" in ast.unparse(ast.parse(
        (REPO / "scripts" / "train_tiny.py").read_text()))
    (_, jspec), = calls["MarkovSpec"]
    (_, spec_kw), = seen["MarkovSpec"]
    assert {k: v for k, v in jspec.items() if k != "vocab_size"} == \
        {k: v for k, v in spec_kw.items() if k != "vocab_size"}
    assert spec_kw["vocab_size"] == run.cfg.vocab_size
    (_, jpipe), = calls["DataPipeline"]
    assert seen["DataPipeline"][0][1] == jpipe
    # one schedule for the base and for each head set, at the default's
    # steps (the test runs 2)
    jtc = [kw for _, kw in calls["TrainConfig"]]
    assert len({tuple(sorted(kw.items())) for kw in jtc}) == 1
    ptc = [kw for _, kw in seen["TrainConfig"]]
    assert ptc == [dict(jtc[0], total_steps=STEPS)]
    assert tiny.TINY_STEPS == jtc[0]["total_steps"] == 300
    assert tiny.train_tiny.__defaults__[0] == tiny.TINY_STEPS
    # the draft variants, their objective, and the seeds (JAX: PRNGKey(0)
    # for the base, fold_in(key, 1) for both head sets)
    kinds = _jax_loop_kinds()
    assert [(k, "data") for k in tiny.TINY_KINDS] == kinds
    assert [kw["objective"] for _, kw in seen["train_heads"]] == \
        [o for _, o in kinds]
    (_, jdc), = calls["DraftConfig"]
    for (a, _), (kind, _) in zip(seen["train_heads"], kinds):
        assert dataclasses.asdict(a[2].draft) == dataclasses.asdict(
            JaxDraftConfig(**dict(jdc, kind=kind)))
    assert calls["PRNGKey"] == [([0], {})]
    assert calls["fold_in"] == [(["key", 1], {})]
    assert [kw["seed"] for _, kw in seen["init_params"]] == [0]
    assert [kw["seed"] for _, kw in seen["init_draft_params"]] == [1, 1]
    # evaluation: the tree, the prompts and the budgets
    assert calls["default_tree"] == [([16, 4, 4], {})]
    assert list(tiny.TINY_TREE) == [16, 4, 4]
    assert calls["eval_batch"] == [([4], {})]
    assert "pipe.eval_batch(4)[:, :32]" in ast.unparse(ast.parse(
        (REPO / "scripts" / "train_tiny.py").read_text()))
    assert tiny.TINY_PROMPTS == (4, 32)
    (_, jgen), = calls["generate"]
    for _, kw in seen["generate"]:
        assert kw == jgen
    assert [a[4].shape for a, _ in seen["generate"]] == [(4, 32)] * 2
    # the checkpoints, in order
    jnames = [a[0] for a, _ in calls["save_checkpoint"]]
    assert [Path(a[0]).name for a, _ in seen["save_checkpoint"]] == [
        "base_tiny", "heads_medusa_tiny", "heads_hydra_tiny"]
    assert jnames[0].endswith("/base_tiny")
    assert "heads_{kind}_tiny" in jnames[1]


def _jax_trees(cfg):
    """JAX-initialised trees of the script's shapes: the base, and each
    kind's heads."""
    jcfg = dataclasses.replace(jax_get_config("vicuna-tiny"),
                               dtype="float32")
    key = jax.random.PRNGKey(0)
    out = {"base": (jcfg, jax_init_params(key, jcfg))}
    for kind in tiny.TINY_KINDS:
        c2 = dataclasses.replace(jcfg, draft=JaxDraftConfig(
            kind=kind, n_heads=4, n_mlp_layers=1))
        out[kind] = (c2, jax_init_draft(jax.random.fold_in(key, 1), c2))
    return out


@pytest.fixture(scope="module")
def restored(recorded):
    """{name: (JAX cfg, the tree JAX restored from the checkpoint)}."""
    run, _, ckpt = recorded
    out = {}
    for name, (jcfg, like) in _jax_trees(run.cfg).items():
        path = ckpt / ("base_tiny" if name == "base"
                       else f"heads_{name}_tiny")
        out[name] = (jcfg, jax_load(str(path), like))
    return out


def test_checkpoints_restore_in_jax_bitwise(recorded, restored):
    run, _, ckpt = recorded
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "base_tiny", "heads_hydra_tiny", "heads_medusa_tiny"]
    for name, (_, jtree) in restored.items():
        port = run.params if name == "base" else run.drafts[name]
        got = port_leaves(port)
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jtree)]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def _stream(toks):
    return [[int(t) for t in row if t != PAD_TOKEN]
            for row in np.asarray(toks)]


@pytest.mark.parametrize("kind", tiny.TINY_KINDS)
def test_generate_on_restored_params_equals_jax(recorded, restored, kind):
    run, _, _ = recorded
    _, jparams = restored["base"]
    jc2, jdp = restored[kind]
    pipe = tiny.tiny_pipeline(run.cfg)
    B, P = tiny.TINY_PROMPTS
    prompts = pipe.eval_batch(B)[:, :P]
    jt, jsteps, jacc = jax_generate(
        jparams, jdp, jc2, jax_default_tree(*tiny.TINY_TREE),
        jnp.asarray(prompts), max_new_tokens=tiny.TINY_NEW,
        max_len=tiny.TINY_MAX_LEN)
    c2 = dataclasses.replace(run.cfg, draft=dataclasses.replace(
        run.cfg.draft, kind=kind, n_heads=4, n_mlp_layers=1))
    t, steps, acc = generate(run.params, run.drafts[kind], c2,
                             default_tree(*tiny.TINY_TREE),
                             torch.from_numpy(prompts).long(),
                             max_new_tokens=tiny.TINY_NEW,
                             max_len=tiny.TINY_MAX_LEN)
    assert steps == jsteps
    assert _stream(t.numpy()) == _stream(jt)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert run.accept[kind] == (float(acc.mean()), steps)


def test_base_setup_restores_the_base_it_wrote(recorded, monkeypatch,
                                               capsys):
    run, _, ckpt = recorded
    monkeypatch.setattr(tiny, "CKPT_DIR", str(ckpt))
    monkeypatch.setattr(tiny, "train_base", lambda *a, **kw: pytest.fail(
        "base_setup trained instead of restoring base_tiny"))
    _, params, _ = tiny.base_setup(device="cpu")
    assert "base_tiny: restored from checkpoint" in capsys.readouterr().out
    for a, b in zip(port_leaves(params), port_leaves(run.params)):
        np.testing.assert_array_equal(a, b)


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_train_tiny", REPO / "scripts" / "torch_train_tiny.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(tiny, "CKPT_DIR", str(tmp_path / "default"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script = _script()
    for call in (lambda: tiny.train_tiny(1),
                 lambda: tiny.train_tiny(1, ckpt_dir=str(tmp_path / "a")),
                 lambda: script.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not list(tmp_path.iterdir())


def test_script_runs_the_recipe(tmp_path, capsys):
    accept = _script().main(["--steps", "1", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "base saved" in out
    for kind in tiny.TINY_KINDS:
        acc, steps = accept[kind]
        assert f"{kind}: acceptance length = {acc:.3f} (steps {steps})" in out
        assert (tmp_path / f"heads_{kind}_tiny" / "arrays.npz").exists()
    assert (tmp_path / "base_tiny" / "arrays.npz").exists()
