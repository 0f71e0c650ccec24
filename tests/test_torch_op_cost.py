"""The op counter (``launch/op_cost.py``) and the kernel wrappers' ``meta``
branches (CPU; nothing is allocated).

* One bf16 and one fp32 matmul: flops 2·M·N·K in their dtype and bytes
  (M·K + K·N + M·N) · element size, exactly; a view moves nothing; peak
  live bytes follow allocations and frees.
* The trip-count property: vicuna-tiny's prefill and decode steps at 4
  layers count exactly twice the per-layer flops, bytes and kernel calls
  of 2 layers (F(4) - F(2) = 2 (F(2) - F(1))): eager code runs every
  layer.
* Each kernel wrapper's ``meta`` call (K1, K4, K2, K3 whole and chunk,
  K5, K6; K3 and K6 under autograd too) returns meta outputs of the
  kernel's shapes, charges one call by the kernel's charge function (the
  bound ``chip_smoke.py`` prints), dispatches no aten op of its plain
  version and counts no launch; a ``cpu`` call gives what the plain
  version gives, bit for bit, and counts no launch either.
* A dense prefill's counted GEMM flops (minitron-4b, prefill_32k) equal
  ``model_flops`` less the embedding and unembedding shares plus the
  last position's logits (relative 1e-12; reason below).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.core.trees import default_tree  # noqa: E402
from repro_torch.kernels.attention_template import ops as k4  # noqa: E402
from repro_torch.kernels.attention_template.ref import (  # noqa: E402
    tree_attention_paged_windowed_plain)
from repro_torch.kernels.flash_attention import ops as k3  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_plain)
from repro_torch.kernels.linear_attn_chunk import ops as k6  # noqa: E402
from repro_torch.kernels.linear_attn_chunk.ref import (  # noqa: E402
    decay_attention_chunked)
from repro_torch.kernels.mla_attention import ops as k5  # noqa: E402
from repro_torch.kernels.mla_attention.ref import (  # noqa: E402
    mla_attention_paged_plain)
from repro_torch.kernels.tree_attention import dense_ops as k2  # noqa: E402
from repro_torch.kernels.tree_attention import ops as k1  # noqa: E402
from repro_torch.kernels.tree_attention.kernel import (  # noqa: E402
    tree_attention_dense_plain, tree_attention_paged_plain)
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.launch.roofline import model_flops  # noqa: E402
from repro_torch.launch.specs import (build_step_spec,  # noqa: E402
                                      make_prefill_step, make_serve_step,
                                      decode_state_structs, param_structs,
                                      draft_param_structs, batch_structs)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import tree_for  # noqa: E402

torch.set_num_threads(2)
BF16, F32 = torch.bfloat16, torch.float32


class Recording(op_cost.OpCounter):
    """The counter, keeping the name of every op it counts."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def _count(self, func, args, kwargs, out):
        self.ops.append(func.overloadpacket.__name__)
        super()._count(func, args, kwargs, out)


# the wrappers' own ops (allocations, casts, pads of small operands, and
# views of the output): none computes attention
WRAPPER_OPS = {"empty_like", "empty", "new_empty", "full", "_to_copy",
               "constant_pad_nd", "clone", "alias", "slice"}


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_matmul_flops_and_bytes_exact(dtype):
    M, K, N = 48, 80, 24
    elt = 2 if dtype == BF16 else 4
    a = torch.empty((M, K), dtype=dtype, device="meta")
    b = torch.empty((K, N), dtype=dtype, device="meta")
    with op_cost.OpCounter() as oc:
        c = a @ b
        bt = b.t()                         # a view: nothing moved
    name = str(dtype).removeprefix("torch.")
    assert dict(oc.flops) == {name: 2 * M * N * K}
    assert oc.bytes == (M * K + K * N + M * N) * elt
    assert oc.compute_s == 2 * M * N * K / PEAK_FLOPS[name]
    assert oc.memory_s == oc.bytes / HBM_BW
    assert oc.peak_live_bytes == M * N * elt
    assert c.is_meta and bt.shape == (N, K)
    # batched, with a bias
    x = torch.empty((3, M, K), dtype=dtype, device="meta")
    w = torch.empty((K, N), dtype=dtype, device="meta")
    bias = torch.empty((N,), dtype=dtype, device="meta")
    with op_cost.OpCounter() as oc:
        torch.nn.functional.linear(x, w.t(), bias)
        torch.bmm(x, x.transpose(1, 2))
    assert dict(oc.flops) == {name: 2 * 3 * M * N * K + 2 * 3 * M * M * K}


def test_peak_live_follows_allocations_and_frees():
    with op_cost.OpCounter() as oc:
        x = torch.empty(1024, device="meta")          # 4 KiB live
        y = x * 2                                      # 8 KiB
        del x                                          # 4 KiB
        z = y + 1                                      # 8 KiB
        v = z[:10]                                     # a view: no more
        del y                                          # 4 KiB
        w = torch.empty(1024, device="meta").expand(4, 1024)
        assert oc.live_bytes == 8192
    assert oc.peak_live_bytes == 8192
    assert v.shape == (10,) and w.stride() == (0, 1)


def _vicuna_counts(layers: int) -> dict:
    cfg = dataclasses.replace(get_config("vicuna-tiny"), n_layers=layers)
    params, dp = param_structs(cfg), draft_param_structs(cfg)
    out = {}
    with op_cost.OpCounter() as oc:
        make_prefill_step(cfg, 128)(params, batch_structs(cfg, 2, 64))
    out["prefill"] = oc
    state = decode_state_structs(cfg, 2, 128, "prefix" in dp)
    with op_cost.OpCounter() as oc:
        make_serve_step(cfg, tree_for(cfg))(params, dp, state)
    out["decode"] = oc
    return out


def test_every_layer_is_counted():
    _vicuna_counts(1)          # the tree's index arrays are made once
    F = {n: _vicuna_counts(n) for n in (1, 2, 4)}
    for step in ("prefill", "decode"):
        f1, f2, f4 = (F[n][step] for n in (1, 2, 4))
        for dt in f4.flops:
            assert f4.flops[dt] - f2.flops[dt] == \
                2 * (f2.flops[dt] - f1.flops[dt]), (step, dt)
        assert f4.bytes - f2.bytes == 2 * (f2.bytes - f1.bytes), step
        per_layer = len(f2.kernels) - len(f1.kernels)
        assert per_layer == 1, step             # one attention call a layer
        assert len(f4.kernels) - len(f2.kernels) == 2 * per_layer, step


# ---------------------------------------------------------------------------
# the wrappers' meta branches
# ---------------------------------------------------------------------------


def _paged_args(device, dtype=BF16, B=2, T=8, Hq=4, Hkv=2, D=64, N=9, bs=16,
                M=4, seed=0, lens=(5, 37)):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).to(dtype).to(device)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32).reshape(B, M) % N
    tree = default_tree(T, 4, 4)
    return (r(B, T, Hq, D), r(N, bs, Hkv, D), r(N, bs, Hkv, D),
            r(B, T, Hkv, D), r(B, T, Hkv, D),
            torch.as_tensor(tree.ancestor_mask).to(device),
            torch.tensor(lens, dtype=torch.int32).to(device),
            table.to(device))


def _mla_args(device, B=2, T=8, H=4, N=9, bs=16, M=4):
    g = torch.Generator().manual_seed(1)
    r = lambda *s, dt=F32: torch.randn(s, generator=g).to(dt).to(device)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32).reshape(B, M) % N
    return (r(B, T, H, 512), r(B, T, H, 64), r(N, bs, 512, dt=BF16),
            r(N, bs, 64, dt=BF16), r(B, T, 512, dt=BF16),
            r(B, T, 64, dt=BF16),
            torch.as_tensor(default_tree(T, 4, 4).ancestor_mask).to(device),
            torch.tensor([5, 37], dtype=torch.int32).to(device),
            table.to(device))


def _k6_args(device, dtype=BF16, B=1, S=100, H=2, d=64, grad=False):
    g = torch.Generator().manual_seed(2)
    r = lambda *s, dt=dtype: torch.randn(s, generator=g).to(dt).to(device)
    args = [r(B, S, H, d), r(B, S, H, d), r(B, S, H, d),
            -torch.exp(r(B, S, H, d, dt=F32)), r(H, d, dt=F32), None]
    if grad:
        for t in args[:5]:
            t.requires_grad_(True)
    return args


def _k3_args(device, dtype=BF16, Sq=128, Skv=128, Hq=4, Hkv=2, D=64,
             grad=False):
    g = torch.Generator().manual_seed(3)
    r = lambda S, H: torch.randn((1, S, H, D), generator=g).to(dtype).to(
        device).requires_grad_(grad)
    return r(Sq, Hq), r(Skv, Hkv), r(Skv, Hkv)


def _charged_once(oc, name, expected):
    assert [(n, c) for n, c, _ in oc.kernels] == [(name, expected)]
    assert set(oc.ops) <= WRAPPER_OPS, oc.ops
    assert dict(oc.flops) == {expected.dtype: expected.flops}
    assert oc.compute_s == expected.ops_s


# (name, module, prep(device) -> the call, its operands made, the charge
# expected on meta, the plain version on the CPU)
def _cases():
    B, T, Hq, Hkv, D, M, bs = 2, 8, 4, 2, 64, 4, 16
    paged = dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, dtype="bfloat16",
                 keys=[M * bs] * B, table_entries=B * M)
    qpos = lambda dev: (torch.tensor([[5], [37]]) + torch.arange(T)).to(dev)

    def prep(fn, make, **kw):
        def at(dev):
            args = make(dev)
            kws = {k: v(dev) if callable(v) else v for k, v in kw.items()}
            return lambda: fn(*args, **kws)
        return at

    dense_args = lambda dev: _paged_args(dev, N=2, bs=32, lens=(5, 20))[:7]
    chunk_kv = lambda dev: torch.tensor([96]).to(dev)
    return [
        ("tree_attention_paged", k1,
         prep(k1.tree_attention_paged_bshd, _paged_args),
         op_cost.paged_charge(**paged),
         lambda: tree_attention_paged_plain(*_paged_args("cpu"))),
        ("tree_attention_paged_windowed", k4,
         prep(k4.tree_attention_paged_windowed_bshd,
              lambda dev: (*_paged_args(dev), qpos(dev), 16)),
         op_cost.paged_charge(**dict(paged, keys=[15] * B, window=16)),
         lambda: tree_attention_paged_windowed_plain(
             *_paged_args("cpu"), qpos("cpu").to(torch.int32), 16)),
        ("tree_attention_dense", k2, prep(k2.tree_attention_bshd, dense_args),
         op_cost.dense_charge(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D,
                              dtype="bfloat16", keys=[32] * B),
         lambda: tree_attention_dense_plain(*dense_args("cpu"))),
        ("mla_attention_paged", k5,
         prep(k5.mla_attention_paged_bshd, _mla_args, scale=0.1),
         op_cost.mla_charge(B=B, T=T, H=4, r=512, rd=64, dtype="bfloat16",
                            keys=[M * bs] * B, table_entries=B * M),
         lambda: mla_attention_paged_plain(*_mla_args("cpu"), scale=0.1)),
        ("flash_attention", k3,
         prep(k3.flash_attention_bshd, _k3_args, window=48),
         op_cost.flash_charge(B=1, Sq=128, keys=128, Hq=4, Hkv=2, dqk=64,
                              dv=64, dtype="bfloat16",
                              pairs=op_cost.k3_pairs(128, 48)),
         lambda: flash_attention_plain(*_k3_args("cpu"), window=48)),
        ("flash_attention", k3,
         prep(k3.flash_attention_bshd, lambda dev: _k3_args(dev, Sq=32),
              q_off=64, kv_valid_len=chunk_kv),
         op_cost.flash_charge(B=1, Sq=32, keys=128, Hq=4, Hkv=2, dqk=64,
                              dv=64, dtype="bfloat16",
                              pairs=op_cost.chunk_rows(96, 32, 0)[0]),
         lambda: flash_attention_plain(
             *_k3_args("cpu", Sq=32), q_off=torch.tensor([64],
                                                         dtype=torch.int32),
             kv_valid_len=torch.tensor([96], dtype=torch.int32))),
        ("linear_attn_chunk", k6, prep(k6.linear_attn_bshd, _k6_args),
         op_cost.k6_charge(B=1, S=100, H=2, d=64, dtype="bfloat16"),
         lambda: decay_attention_chunked(*_k6_args("cpu"), chunk=64)),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] + str(i) for i, c in enumerate(CASES)])
def test_meta_call_is_charged_by_its_bound(case):
    name, mod, prep, expected, _ = CASES[case]
    before = dict(mod.__dict__)
    run = prep("meta")
    with Recording() as oc:
        out = run()
    _charged_once(oc, name, expected)
    if set(oc.ops) <= {"empty_like", "empty", "new_empty", "alias", "slice"}:
        assert oc.bytes == expected.nbytes          # nothing but the charge
    else:
        assert oc.bytes > expected.nbytes           # + the wrapper's casts
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t.is_meta for t in outs)
    cpu = prep("cpu")()
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    assert [tuple(t.shape) for t in outs] == [tuple(t.shape) for t in cpu]
    # no launch counted on meta (nor on the CPU)
    for counter in ("launches", "merge_launches", "scan_launches",
                    "chunk_launches", "grad_launches"):
        assert getattr(mod, counter, 0) == before.get(counter, 0), counter
    # outside a counter a meta call records nothing and still works
    run()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] + str(i) for i, c in enumerate(CASES)])
def test_cpu_call_is_the_plain_version_bit_for_bit(case):
    name, mod, prep, _, plain = CASES[case]
    got, want = prep("cpu")(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert torch.equal(g, w.to(g.dtype)), name


@pytest.mark.parametrize("which", ["flash_attention", "linear_attn_chunk"])
def test_meta_autograd_charges_forward_and_counts_the_plain_backward(which):
    if which == "flash_attention":
        args = _k3_args("meta", grad=True)
        fwd = lambda: k3.flash_attention_bshd(*args)
    else:
        args = _k6_args("meta", grad=True)
        fwd = lambda: k6.linear_attn_bshd(*args)[0]
    assert all(t.is_leaf for t in args if isinstance(t, torch.Tensor))
    with torch.enable_grad(), Recording() as oc:
        out = fwd()
        n_fwd_ops = len(oc.ops)
        out.float().sum().backward()
    assert [n for n, _, _ in oc.kernels] == [which]
    assert set(oc.ops[:n_fwd_ops]) <= WRAPPER_OPS
    kernel_flops = oc.kernels[0][1].flops
    assert sum(oc.flops.values()) > kernel_flops   # the backward's GEMMs
    for t in args:
        if isinstance(t, torch.Tensor) and t.requires_grad:
            assert t.grad is not None and t.grad.is_meta
            assert t.grad.shape == t.shape


def test_other_devices_still_raise():
    """The meta branch is the only new one: a device neither cpu, cuda nor
    meta raises (a tensor on it cannot be made here; the wrappers' checks
    name the device type they refuse)."""
    import inspect

    for mod, fn in ((k1, "tree_attention_paged_bshd"),
                    (k4, "tree_attention_paged_windowed_bshd"),
                    (k2, "tree_attention_bshd"),
                    (k5, "mla_attention_paged_bshd"), (k3, "_forward"),
                    (k6, "_forward")):
        src = inspect.getsource(getattr(mod, fn))
        assert "raise ValueError(f\"no " in src, fn


def test_dense_prefill_gemm_flops_match_model_flops():
    """minitron-4b's prefill_32k: the counted matmul flops (the kernel
    charges taken out) against ``model_flops`` = 2 N D less the embedding
    lookup (no GEMM) and the unembedding (a GEMM for the last position
    only), plus that last position's logits.  ``n_params`` counts the
    embeddings and the GEMM weights alone (no norm, no bias), so the two
    agree to rounding: the test holds them to relative 1e-12."""
    cfg = get_config("minitron-4b")
    shp = INPUT_SHAPES["prefill_32k"]
    spec = build_step_spec(cfg, "prefill_32k", make_host_mesh())
    with op_cost.OpCounter() as oc:
        spec.fn(*spec.args)
    kernel_flops = sum(c.flops for _, c, _ in oc.kernels)
    assert [n for n, _, _ in oc.kernels] == ["flash_attention"] * cfg.n_layers
    counted = sum(oc.flops.values()) - kernel_flops
    tok = shp.global_batch * shp.seq_len
    V, d = cfg.vocab_size, cfg.d_model
    vocab_params = V * d * (1 if cfg.tie_embeddings else 2)
    want = (model_flops(cfg, shp) - 2 * tok * vocab_params
            + 2 * shp.global_batch * d * V)
    assert abs(counted - want) <= 1e-12 * want
