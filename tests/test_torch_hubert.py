"""hubert-xlarge, the encoder-only registry config, through the port
against the JAX reference.

* the config equals JAX's field for field (and so does ``reduced()``);
  the group program is one ``attn_stack_dense`` group; the params carry
  ``mask_embed (d,)`` and an untied ``lm_head (d, V)``, through the bridge
  too, which refuses a tree without ``mask_embed``;
* ``forward`` over frame embeddings ``(B, S, d)`` at ``reduced()`` with
  head dim 64 and with hubert's 80 equals JAX's ``forward`` in hidden
  states and logits at ``atol = rtol = 1e-4`` (fp32);
* it is bidirectional: changing the last frame changes the first frame's
  output, while the same weights run causally leave it bit for bit as it
  was (so a causal attention fails the check);
* an encoder has no decode path: ``init_cache``, a ``forward`` with a
  cache, the engines, ``generate()`` and the launcher refuse it, the
  launcher with JAX's message;
* K3's wrapper takes the bf16 (80, 80) build and still refuses an
  unbuilt width; ``gpu``-marked, on the card: K3 at hubert's heads (16
  over 16, D = 80, bidirectional) against its plain version, fp32 and
  bf16.  Run there with
  ``python -m pytest --noconftest -m gpu tests/test_torch_hubert.py``
  (that machine has no JAX; the gpu cases use none).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:     # the card's machine has no JAX: its gpu-marked cases need none
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import model as jax_model
except ImportError:
    jax = jnp = jax_get_config = jax_model = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, tree_for  # noqa: E402
from repro_torch.core.speculative import generate  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k3  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import (forward, group_program,  # noqa: E402
                                      init_cache, init_params)
from repro_torch.serving.engine import (BucketedEngine,  # noqa: E402
                                        PagedSpeculativeEngine,
                                        SpeculativeEngine)

torch.set_num_threads(2)
ARCH = "hubert-xlarge"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24


def _reduced(get, head_dim: int):
    return dataclasses.replace(get(ARCH).reduced(), dtype="float32",
                               head_dim=head_dim)


@needs_jax
@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_jax(reduce):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == (
        48, 1280, 16, 16, 80, 5120, 504)
    assert full.encoder_only and full.modality == "audio"
    assert not full.supports_decode and tree_for(full) is None


def test_group_program_and_params():
    cfg = _reduced(get_config, 80)
    assert group_program(get_config(ARCH)) == [("attn_stack_dense", 48)]
    params = init_params(cfg, seed=0, device="cpu")
    d, V = cfg.d_model, cfg.vocab_size
    assert tuple(params["mask_embed"].shape) == (d,)
    assert tuple(params["lm_head"].shape) == (d, V)
    assert tuple(params["groups"][0]["attn"]["wq"].shape) == (2, d, 4 * 80)


@pytest.fixture(scope="module", params=[64, 80], ids=["hd64", "hd80"])
def model(request):
    """(jax cfg, port cfg, jax params, port params) at reduced() with the
    given head dim, JAX-initialised."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    jcfg = _reduced(jax_get_config, request.param)
    cfg = _reduced(get_config, request.param)
    jparams = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _frames(cfg, seed: int = 0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _port_forward(params, cfg, frames):
    pos = torch.arange(S).expand(B, S)
    return forward(params, cfg, torch.from_numpy(frames), pos, mode="full")


def test_bridge_round_trip_and_refusal(model):
    jcfg, cfg, jparams, params = model
    back = bridge.to_numpy(params)
    np.testing.assert_array_equal(back["mask_embed"],
                                  np.asarray(jparams["mask_embed"]))
    np.testing.assert_array_equal(back["lm_head"],
                                  np.asarray(jparams["lm_head"]))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    del tree["mask_embed"]
    with pytest.raises(ValueError, match="mask_embed"):
        bridge.params_from_jax(tree, cfg, "cpu")


def test_encoder_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    frames = _frames(cfg)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jout = jax_model.forward(jparams, jcfg, jnp.asarray(frames),
                             jnp.asarray(pos), mode="full")
    out = _port_forward(params, cfg, frames)
    assert out.cache is None and out.logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(jout.hidden),
                               **TOL)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               **TOL)


def test_encoder_is_bidirectional(model):
    """The last frame reaches the first frame's output; run causally, the
    same weights leave it bit for bit."""
    _, cfg, _, params = model
    frames = _frames(cfg, 1)
    moved = frames.copy()
    moved[:, -1] += 1.0
    a, b = (_port_forward(params, cfg, f).hidden for f in (frames, moved))
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3
    causal = dataclasses.replace(cfg, encoder_only=False)
    a, b = (_port_forward(params, causal, f).hidden for f in (frames, moved))
    assert torch.equal(a[:, :-1], b[:, :-1])


def test_encoder_has_no_decode_path():
    cfg = _reduced(get_config, 80)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        init_cache(cfg, 1, 16, "cpu")
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="encoder-only"):
        forward(params, cfg, torch.zeros((1, 4, cfg.d_model)), pos,
                mode="full", cache=[{}])
    for cls in (SpeculativeEngine, PagedSpeculativeEngine, BucketedEngine):
        with pytest.raises(ValueError, match="encoder-only"):
            cls(params, None, cfg, None, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        generate(params, None, cfg, None, torch.zeros((1, 4), dtype=torch.long),
                 max_new_tokens=2)


def test_launcher_refuses_with_the_reference_message():
    """The message of ``repro/launch/serve.py``."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--device", "cpu"])
    assert str(e.value) == ("hubert-xlarge is encoder-only: no decode "
                            "service (DESIGN.md §4)")


def test_k3_wrapper_takes_the_80_build_only():
    """The bf16 builds' widths pass the wrapper's CUDA checks; an unbuilt
    width raises (checked on CPU tensors: the checks read no device)."""
    def qkv(d):
        return [torch.zeros((1, 8, 2, d), dtype=torch.bfloat16)
                for _ in range(3)]
    k3._check_cuda(*qkv(80))
    with pytest.raises(ValueError, match="head dims"):
        k3._check_cuda(*qkv(96))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("seq", [37, 300])
def test_cuda_flash_attention_at_head_dim_80(monkeypatch, dtype, tol, seq):
    """K3 at hubert's heads (16 over 16, D = 80), bidirectional, against
    its plain version; fp32 runs its own (80, 80) build, unpadded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_plain

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(seq)
    q, k, v = (torch.randn((1, seq, 16, 80), generator=g).to(
        "cuda", getattr(torch, dtype)) for _ in range(3))
    before = k3.launches
    out = k3.flash_attention_bshd(q, k, v, causal=False)
    ref = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert k3.launches == before + 1 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
