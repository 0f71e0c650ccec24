"""The port's block-size autotuner: the lookup in ``repro_torch/kernels/
__init__.py`` (``tuned_block_sizes``), the sweep harness
``repro_torch/kernels/autotune.py`` and the committed
``results/autotune.cuda.json``, on the CPU:

* the modes against a temporary cache: a hit returns the winner, a miss
  warns once and returns the defaults, ``off`` ignores the cache, and
  ``sweep`` raises without a card and while a graph is being captured;
* without a cache, or in mode ``off``, K3 resolves the key tile it ran
  before the cache existed (64, 32 at 256), once a process per shape,
  and the CPU path consults nothing;
* ``required_keys()`` is the set of keys K3's own resolve function
  derives for every registry config at full width, each at the config's
  own heads;
* the committed cache covers every required key with a candidate, names
  the card and its power limit, and ``check`` passes (and fails on a
  cache with a key removed).

The ``gpu``-marked cases hold every key tile against its plain version
on the card, with a chunk's rows equal to the whole prefill's; they skip
without a card and import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_autotune.py
"""
import json
import logging
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k3  # noqa: E402
from repro_torch.kernels.flash_attention import ops as k3_ops  # noqa: E402

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
COMMITTED = REPO / "results" / "autotune.cuda.json"
HIT = "flash|dqk=64|dv=64|hq=4|hkv=2|causal=1"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A temporary winner cache holding ``HIT`` (key tile 32), the
    lookup's state cleared before and after."""
    path = tmp_path / "autotune.cuda.json"
    path.write_text(json.dumps({"entries": {
        HIT: {"key_tile": 32, "sweep_us": {"32": 1.0, "64": 2.0,
                                           "128": 3.0}}}}))
    monkeypatch.setenv(kernels.AUTOTUNE_CACHE_ENV, str(path))
    monkeypatch.delenv(kernels.AUTOTUNE_ENV, raising=False)
    _clear()
    yield path
    _clear()


def _clear():
    kernels._load_winner_cache.cache_clear()
    kernels._warned_keys.clear()
    kernels._swept_keys.clear()
    k3_ops.resolve_key_tile.cache_clear()


def _flash(hq=4, hkv=2, dims=(64, 64), causal=True):
    return k3_ops.tuning_shape(*dims, hq, hkv, causal)


DEFAULT = {"key_tile": 64}


def test_a_hit_returns_the_winner(cache):
    assert kernels.block_size_key("flash", _flash()) == HIT
    got = kernels.tuned_block_sizes("flash", _flash(), defaults=DEFAULT)
    assert got == {"key_tile": 32}
    assert k3_ops.resolve_key_tile(64, 64, 4, 2, True) == 32
    # another head count or mask is another key: a miss
    assert k3_ops.resolve_key_tile(64, 64, 8, 2, True) == 64
    assert k3_ops.resolve_key_tile(64, 64, 4, 2, False) == 64


def test_a_miss_warns_once_and_returns_the_defaults(cache, caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.kernels"):
        for _ in range(3):
            got = kernels.tuned_block_sizes("flash", _flash(hq=6),
                                            defaults=DEFAULT)
            assert got == DEFAULT
    warned = [r for r in caplog.records if "no winner" in r.getMessage()]
    assert len(warned) == 1
    assert "flash|dqk=64|dv=64|hq=6|hkv=2|causal=1" in warned[0].getMessage()


def test_off_ignores_the_cache(cache, monkeypatch):
    monkeypatch.setenv(kernels.AUTOTUNE_ENV, "off")
    assert kernels.tuned_block_sizes("flash", _flash(),
                                     defaults=DEFAULT) == DEFAULT


def test_sweep_raises_without_a_card(cache, monkeypatch):
    monkeypatch.setenv(kernels.AUTOTUNE_ENV, "sweep")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernels.tuned_block_sizes("flash", _flash(hq=6), defaults=DEFAULT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.main(["sweep", "--out", str(cache.parent / "x.json")])
    # a key the cache holds needs no sweep
    assert kernels.tuned_block_sizes(
        "flash", _flash(), defaults=DEFAULT) == {"key_tile": 32}


def test_sweep_raises_under_a_graph_capture(cache, monkeypatch):
    monkeypatch.setenv(kernels.AUTOTUNE_ENV, "sweep")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(autotune, "sweep_entry", lambda *a: pytest.fail(
        "a sweep started under a capture"))
    with pytest.raises(RuntimeError, match="captured"):
        kernels.tuned_block_sizes("flash", _flash(hq=6), defaults=DEFAULT)


def test_a_swept_key_is_timed_once(cache, monkeypatch):
    monkeypatch.setenv(kernels.AUTOTUNE_ENV, "sweep")
    calls = []

    def fake(variant, shape):
        calls.append((variant, dict(shape)))
        return {"key_tile": 128, "sweep_us": {}}

    monkeypatch.setattr(autotune, "sweep_entry", fake)
    for _ in range(2):
        assert kernels.tuned_block_sizes(
            "flash", _flash(hq=6), defaults=DEFAULT) == {"key_tile": 128}
    assert calls == [("flash", _flash(hq=6))]


@pytest.mark.parametrize("how", ["no cache", "off"])
def test_the_defaults_are_the_old_constants(tmp_path, monkeypatch, how):
    monkeypatch.setenv(kernels.AUTOTUNE_CACHE_ENV,
                       str(tmp_path / "missing.json"))
    if how == "off":
        monkeypatch.setenv(kernels.AUTOTUNE_CACHE_ENV, str(COMMITTED))
        monkeypatch.setenv(kernels.AUTOTUNE_ENV, "off")
    _clear()
    try:
        for dims in k3.DIMS:
            want = 64      # every build's default on the wgmma body
            for hq, hkv in ((16, 16), (24, 8), (64, 8)):
                assert k3_ops.resolve_key_tile(*dims, hq, hkv, True) == want
            assert want in k3.KEY_TILES[dims]
            assert k3.DEFAULT_KEY_TILE[dims] == want
    finally:
        _clear()


def test_a_shape_is_resolved_once(cache, monkeypatch):
    """The eager path pays for the lookup once a shape: a second call of
    the same shape reads no environment and builds no key."""
    seen = []

    def record(variant, shape, *, defaults):
        seen.append(kernels.block_size_key(variant, shape))
        return {"key_tile": 32}

    monkeypatch.setattr(k3_ops, "tuned_block_sizes", record)
    for _ in range(3):
        assert k3_ops.resolve_key_tile(128, 128, 24, 8, True) == 32
        assert k3_ops.resolve_key_tile(128, 128, 64, 8, True) == 32
    assert seen == ["flash|dqk=128|dv=128|hq=24|hkv=8|causal=1",
                    "flash|dqk=128|dv=128|hq=64|hkv=8|causal=1"]


def test_the_cpu_path_consults_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CPU path consulted the cache")

    monkeypatch.setattr(k3_ops, "tuned_block_sizes", refuse)
    k3_ops.resolve_key_tile.cache_clear()
    try:
        q = torch.randn(1, 20, 4, 64)
        k3_ops.flash_attention_bshd(q, q[:, :, :2].contiguous(),
                                    q[:, :, :2].contiguous())
        k3_ops.flash_attention_bshd(
            q[:, 8:], q[:, :, :2].contiguous(), q[:, :, :2].contiguous(),
            q_off=8, kv_valid_len=torch.tensor([20], dtype=torch.int32))
    finally:
        k3_ops.resolve_key_tile.cache_clear()


# ---------------------------------------------------------------------------
# required keys
# ---------------------------------------------------------------------------

# the K3 calls the registry resolves at full width, each at its config's
# heads: (128, 128) at chameleon-34b (64/8), deepseek-moe-16b and
# deepseek-v2-lite-16b's prefix layer (16/16), minitron-4b (24/8),
# qwen2.5-32b (40/8) and starcoder2-7b (36/4); deepseek-v2-lite-16b's MLA
# prefill (192, 128) at 16/16; gemma3-1b (256, 256) at 4/1; hubert-xlarge
# (80, 80) at 16/16, bidirectional; vicuna-tiny (64, 64) at 4/4 and
# zamba2-1.2b's shared block at 32/32
EXPECTED_KEYS = [
    f"flash|dqk={a}|dv={b}|hq={h}|hkv={kv}|causal={c}"
    for a, b, h, kv, c in (
        (128, 128, 64, 8, 1), (128, 128, 16, 16, 1), (128, 128, 24, 8, 1),
        (128, 128, 40, 8, 1), (128, 128, 36, 4, 1), (192, 128, 16, 16, 1),
        (256, 256, 4, 1, 1), (80, 80, 16, 16, 0), (64, 64, 4, 4, 1),
        (64, 64, 32, 32, 1))]


def test_required_keys_are_the_registrys():
    assert sorted(autotune.required_keys()) == sorted(EXPECTED_KEYS)


@pytest.mark.parametrize("name", list_configs())
def test_required_keys_are_what_the_wrappers_resolve(name, monkeypatch):
    """Each tuned call of a config, fed to K3's own resolve function at
    the call's shapes, looks up the key ``required_keys`` lists."""
    seen = []

    def record(variant, shape, *, defaults):
        seen.append(kernels.block_size_key(variant, shape))
        return dict(defaults)

    monkeypatch.setattr(k3_ops, "tuned_block_sizes", record)
    k3_ops.resolve_key_tile.cache_clear()
    try:
        cfg = get_config(name)
        want = [kernels.block_size_key(variant, shape)
                for variant, shape in autotune.calls_for(cfg)]
        resolved = autotune.resolve_calls(cfg)
    finally:
        k3_ops.resolve_key_tile.cache_clear()
    assert seen == want and list(resolved) == want
    assert set(want) <= set(autotune.required_keys())


def test_configs_sharing_a_build_keep_their_own_keys():
    """minitron-4b's (128, 128) prefill is not timed at chameleon-34b's
    heads: the head count is in the key."""
    keys = {name: [k for k in autotune.resolve_calls(get_config(name))
                   if k.startswith("flash|dqk=128|dv=128|")]
            for name in ("minitron-4b", "chameleon-34b")}
    assert keys == {
        "minitron-4b": ["flash|dqk=128|dv=128|hq=24|hkv=8|causal=1"],
        "chameleon-34b": ["flash|dqk=128|dv=128|hq=64|hkv=8|causal=1"]}


@pytest.mark.parametrize("dims", k3.DIMS)
def test_a_forced_key_tile_is_checked(dims):
    tiles = k3.KEY_TILES[dims]
    for n in tiles:
        k3_ops.check_key_tile(*dims, n)
        assert k3.mma_smem_bytes(*dims, n) <= k3.MAX_SMEM
    for n in (0, 48, *(t for t in k3.TILE_CANDIDATES if t not in tiles)):
        with pytest.raises(ValueError, match="key tile"):
            k3_ops.check_key_tile(*dims, n)
    # the (256, 256) build's ring of 128-key tiles exceeds shared memory
    if dims == (256, 256):
        assert tiles == (32, 64)
        assert k3.mma_smem_bytes(256, 256, 128) > k3.MAX_SMEM


# ---------------------------------------------------------------------------
# the committed cache
# ---------------------------------------------------------------------------


def _committed() -> dict:
    return json.loads(COMMITTED.read_text())


def test_the_committed_cache_holds_a_candidate_for_every_key():
    data = _committed()
    req = autotune.required_keys()
    assert set(req) <= set(data["entries"])
    for key, (variant, shape) in req.items():
        entry = data["entries"][key]
        winner = {k: v for k, v in entry.items() if k != "sweep_us"}
        cands = autotune.candidates(variant, shape)
        assert winner in cands, (key, winner)
        assert set(entry["sweep_us"]) == {autotune.label(c) for c in cands}
        assert all(us > 0 for us in entry["sweep_us"].values())


def test_the_committed_cache_names_the_card_and_its_power_limit():
    data = _committed()
    assert data["backend"] == "cuda"
    name, limit = (s.strip() for s in data["card"].split(","))
    assert "H100" in name and data["device"] in name
    assert limit.endswith(" W") and float(limit[:-2]) > 0
    assert data["torch"] and data["cuda"]


def test_check_passes_and_fails_on_a_missing_key(tmp_path, capsys):
    assert autotune.main(["check", "--cache", str(COMMITTED)]) == 0
    assert "OK" in capsys.readouterr().out
    data = _committed()
    gone = sorted(autotune.required_keys())[0]
    del data["entries"][gone]
    cut = tmp_path / "cut.json"
    cut.write_text(json.dumps(data))
    assert autotune.main(["check", "--cache", str(cut)]) == 1
    out = capsys.readouterr().out
    assert "FAIL" in out and gone in out
    assert autotune.main(["check", "--cache", str(tmp_path / "no.json")]) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    from repro_torch.kernels import build
    build.build()


@pytest.mark.gpu
@pytest.mark.parametrize("key", [EXPECTED_KEYS[i] for i in (2, 5, 6, 7, 9)])
def test_every_candidate_matches_its_plain_version(card, key):
    """The sweep's checks at a key of each build: every key tile within
    phase 3's bf16 tolerance of its plain version (a causal one also a
    chunk == the whole prefill's rows)."""
    variant, shape = autotune.required_keys()[key]
    _, check, _ = autotune.BENCHES[variant](shape, torch.device("cuda"))
    with torch.no_grad():
        for cand in autotune.candidates(variant, shape):
            check(cand, f"{key} {autotune.label(cand)}")


@pytest.mark.gpu
@pytest.mark.parametrize("dims", k3.DIMS)
def test_k3_chunk_equals_whole_under_each_key_tile(card, dims):
    dqk, dv = dims
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda h, d: torch.randn((1, 700, h, d), generator=g,
                                 device="cuda").to(torch.bfloat16)
    q, k, v = r(4, dqk), r(2, dqk), r(2, dv)
    for n in k3.KEY_TILES[dims]:
        whole = k3_ops.flash_attention_bshd(q, k, v, key_tile=n)
        for lo in (0, 128, 640):
            hi = min(lo + 128, 700)
            chunk = k3_ops.flash_attention_bshd(
                q[:, lo:hi].contiguous(), k, v, q_off=lo,
                kv_valid_len=torch.full((1,), hi, dtype=torch.int32,
                                        device="cuda"), key_tile=n)
            assert torch.equal(chunk, whole[:, lo:hi]), (dims, n, lo)
