"""The port's trainer and train launcher against the JAX package (fp32,
CPU).

* three steps of ``make_base_train_step`` and of ``make_head_train_step``
  (Hydra++, the prefix layer trained) from the same params and batches as
  JAX's jitted steps: every leaf within relative L2 1e-4 after each step;
  the head step leaves the base params bitwise unchanged and gives no
  base param a ``.grad``;
* the slice as a whole: JAX's ``train_heads`` and the port's, three steps
  each, then greedy ``generate`` from each side's own trained params: the
  streams are token-identical (a divergence is reported with the top-2
  logit gap where it lands, to name a near tie);
* after base training of a tied model (gemma3-1b ``reduced()``) the fp32
  unembedding is refreshed, and serving's first token equals the argmax
  of logits computed from ``embed`` directly;
* ``python -m repro_torch.launch.train --device cpu`` prints JAX's
  ``[train]`` lines with finite losses (the recurrent and MoE archs are
  trained in ``tests/test_torch_train_archs.py``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_training import (assert_trees_close, cfg_pair, to_np,  # noqa: E402
                             tokens)
from repro.core.heads import init_draft_params as jax_init_draft  # noqa: E402
from repro.core.speculative import generate as jax_generate  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro.training.optim import init_adamw as jax_init_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import tree_for  # noqa: E402
from repro_torch.core.speculative import (PAD_TOKEN, generate,  # noqa: E402
                                          init_decode_state)
from repro_torch.data.synthetic import MarkovSpec, sample_corpus  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.model import forward  # noqa: E402
from repro_torch.training import trainer  # noqa: E402
from repro_torch.training.optim import init_adamw  # noqa: E402
from repro_torch.training.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(2)
REL = 1e-4
TC = dict(peak_lr=3e-3, warmup=1, total_steps=10, log_every=1)
HYDRA_PP = dict(kind="hydra++", n_heads=3, n_mlp_layers=2,
                prefix_attention=True)


def _setup(name="vicuna-tiny", seed=0, **kw):
    jcfg, cfg = cfg_pair(name, **kw)
    key = jax.random.PRNGKey(seed)
    jparams = jax_init_params(key, jcfg)
    jdp = jax_init_draft(jax.random.fold_in(key, 1), jcfg)
    params = bridge.params_from_jax(to_np(jparams), cfg, device="cpu")
    dp = bridge.draft_params_from_jax(to_np(jdp), cfg, device="cpu")
    return jcfg, cfg, jparams, jdp, params, dp


def _batches(cfg, n=3, B=2, S=40, seed=1):
    return [sample_corpus(MarkovSpec(vocab_size=cfg.vocab_size, seed=0), B,
                          S, seed=seed + i) for i in range(n)]


def test_base_train_steps_match_jax():
    jcfg, cfg, jparams, _, params, _ = _setup()
    jstep = jtrainer.make_base_train_step(jcfg, jtrainer.TrainConfig(**TC))
    step = trainer.make_base_train_step(cfg, trainer.TrainConfig(**TC))
    jopt, opt = jax_init_adamw(jparams), init_adamw(params)
    for i, b in enumerate(_batches(cfg)):
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(b))
        params, opt, m = step(params, opt, torch.from_numpy(b))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert_trees_close(params, jparams, REL, f"params after step {i}")
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    assert torch.equal(params["unembed_f32"], w)
    assert not any(p.requires_grad or p.grad is not None
                   for p in tree_leaves(params))


def test_head_train_steps_match_jax():
    jcfg, cfg, jparams, jdp, params, dp = _setup(draft=HYDRA_PP)
    base_before = [p.clone() for p in tree_leaves(params)]
    jstep = jtrainer.make_head_train_step(jcfg, jtrainer.TrainConfig(**TC),
                                          objective="distill")
    step = trainer.make_head_train_step(cfg, trainer.TrainConfig(**TC),
                                        objective="distill")
    jopt, opt = jax_init_adamw(jdp), init_adamw(dp)
    for i, b in enumerate(_batches(cfg)):
        jdp, jopt, jm = jstep(jdp, jparams, jopt, jnp.asarray(b),
                              jax.random.PRNGKey(i))
        dp, opt, m = step(dp, params, opt, torch.from_numpy(b))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert_trees_close(dp, jdp, REL, f"draft params after step {i}")
    for a, b in zip(base_before, tree_leaves(params)):
        assert torch.equal(a, b) and b.grad is None and not b.requires_grad
    assert not any(p.grad is not None or p.requires_grad
                   for p in tree_leaves(dp))


def _stream(row):
    return [int(t) for t in np.asarray(row) if t != PAD_TOKEN]


def _top2_gap(params, cfg, context) -> float:
    """The top-2 logit gap of the next token after ``context``."""
    x = torch.tensor([context])
    with torch.no_grad():
        lg = forward(params, cfg, x, torch.arange(len(context))[None]).logits
    top = torch.topk(lg[0, -1], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("kind", ["hydra", "hydra++"])
def test_train_heads_then_generate_matches_jax(kind):
    draft = HYDRA_PP if kind == "hydra++" else dict(
        kind="hydra", n_heads=3, n_mlp_layers=1, prefix_attention=False)
    jcfg, cfg, jparams, jdp, params, dp = _setup(draft=draft, seed=3)
    batches = _batches(cfg, seed=7)
    jdp, _ = jtrainer.train_heads(jdp, jparams, jcfg,
                                  jtrainer.TrainConfig(**TC), batches,
                                  log=None)
    dp, _ = trainer.train_heads(dp, params, cfg, trainer.TrainConfig(**TC),
                                batches, log=None)
    assert_trees_close(dp, jdp, REL, "trained heads")
    tree = tree_for(cfg)
    prompt = tokens(9, 2, 12, cfg.vocab_size)
    jt, _, _ = jax_generate(jparams, jdp, jcfg, tree, jnp.asarray(prompt),
                            max_new_tokens=16, max_len=64)
    with torch.no_grad():
        pt, _, _ = generate(params, dp, cfg, tree,
                            torch.from_numpy(prompt).long(),
                            max_new_tokens=16, max_len=64)
    for b in range(2):
        want, got = _stream(jt[b])[:16], _stream(pt[b])[:16]
        if got != want:
            k = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
            gap = _top2_gap(params, cfg, list(prompt[b]) + got[:k])
            raise AssertionError(
                f"row {b} diverges at token {k} ({got[k]} vs JAX {want[k]}); "
                f"top-2 logit gap there {gap:.3e}"
                f"{' (a near tie)' if gap < 1e-4 else ''}")


def test_refreshed_unembed_serves_the_trained_embedding():
    jcfg, cfg = cfg_pair("gemma3-1b", vocab_size=256)
    assert cfg.tie_embeddings
    from repro_torch.models.model import init_params
    params = init_params(cfg, seed=0, device="cpu")
    stale = params["unembed_f32"].clone()
    params, _ = trainer.train_base(params, cfg, trainer.TrainConfig(**TC),
                                   _batches(cfg), log=None)
    assert not torch.equal(stale, params["embed"].T)
    assert torch.equal(params["unembed_f32"], params["embed"].T)
    prompt = torch.from_numpy(tokens(4, 2, 20, cfg.vocab_size)).long()
    with torch.no_grad():
        st = init_decode_state(params, None, cfg, prompt, 64)
        h = forward(params, cfg, prompt, torch.arange(20).expand(2, 20),
                    want_logits=False).hidden[:, -1]
    direct = torch.argmax(h.float() @ params["embed"].float().T, dim=-1)
    assert torch.equal(st.last_token, direct)


def test_train_launcher_prints_jax_lines(capsys):
    history = launcher.main(["--arch", "vicuna-tiny", "--steps", "3",
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[train] arch=vicuna-tiny-smoke devices=1")
    losses = [float(x) for x in re.findall(
        r"^\[train +\d+\] loss=([-\d.naif]+) \(", out, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses))    # steps 0 and 2
    assert [round(l, 4) for l, _ in history[::2]] == losses
    assert out.rstrip().endswith("[train] done")


def test_train_launcher_audio(capsys):
    launcher.main(["--arch", "hubert-xlarge", "--steps", "2", "--batch", "2",
                   "--seq-len", "24", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=hubert-xlarge-smoke" in out and "[train] done" in out
