"""One K5 launch for the int8 products that share an input (a layer's
q/k/v, its gate/up): ``ops/quant.dequant_matmul_group``,
``ops/routed_lora.routed_lora_matmul_group`` and ``core/llama._layer``
against the JAX package's ``dequant_matmul`` and decode step, on the CPU.

On the CPU the grouped call runs each member as ``dequant_matmul`` runs it
alone (the plain product); K5 has no CPU build, and its card tests are in
tests/test_torch_kernels_cuda.py.  The layer's grouping is also run here
with the card's launch rule emulated (``k5_groups`` without its CUDA
check, the grouped launch replaced by the members' plain products, every
launch counted where the card would make one), so its plumbing, its
results and its launch count are checked without a card.

Inputs are seeded numpy arrays handed to both packages.  Tolerances,
relative to max |JAX|: 1e-5 for an fp32 product (int8 and bf16 values are
exact in fp32, so only the summation order differs), 2e-2 for a bf16 one
(one bf16 rounding of a sum taken in another order); logits as
tests/test_torch_llama.py holds them (1e-4 fp32, 2e-2 bf16).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.core import llama as jllama
from modelcompose_tpu.ops import quant as jquant

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.core import llama
from modelcompose_tpu_torch.core.decode_graph import _decode_step
from modelcompose_tpu_torch.core.prefill_graph import _prefill
from modelcompose_tpu_torch.ops import quant, routed_lora

jgen = importlib.import_module("modelcompose_tpu.core.generate")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (K, [N, ...], out_dtype): narrow versions of q/k/v (GQA: narrower k, v)
# and gate/up, and a ragged K with N % 128 != 0
GROUPS = {"qkv": (128, [128, 32, 32], "float32"),
          "gate_up": (96, [272, 272], None),
          "ragged": (344, [48, 16, 64], "float32")}
ROWS = [1, 2, 3, 8, 37]


def _rel(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().detach().numpy()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _weights(rng, K, Ns):
    pairs = []
    for N in Ns:
        w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
        jwq = jquant.quantize_int8(jnp.asarray(w))
        pairs.append((jwq, {k: torch.from_numpy(np.array(v))
                            for k, v in jwq.items()}))
    return pairs


def _x(rng, M, K, dtype):
    x = rng.normal(size=(M, 1, K)).astype(np.float32)  # decode's [B, 1, K]
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("group", list(GROUPS))
def test_group_plain_path_matches_jax(group, M, dtype):
    """Each member of a grouped call against the JAX ``dequant_matmul`` of
    its weight, in its own output, with no launch (CPU tensors)."""
    K, Ns, out = GROUPS[group]
    rng = np.random.default_rng(K + M + len(Ns))
    pairs = _weights(rng, K, Ns)
    tx, jx = _x(rng, M, K, dtype)
    t_out = out and getattr(torch, out)
    before = quant.dequant_matmul.launches
    got = quant.dequant_matmul_group(tx, [t for _, t in pairs],
                                     out_dtype=t_out)
    assert quant.dequant_matmul.launches == before
    assert len(got) == len(Ns)
    for y, (jwq, _), N in zip(got, pairs, Ns):
        want = jquant.dequant_matmul(jx, jwq,
                                     out_dtype=out and getattr(jnp, out))
        assert tuple(y.shape) == (M, 1, N)
        assert y.dtype == (t_out or tx.dtype)
        assert _rel(y, want) <= TOL["float32" if out else dtype]


def test_group_reference_impl_and_bad_impl():
    """impl "reference" runs every member's plain product; an unknown impl
    raises, as ``dequant_matmul`` does."""
    rng = np.random.default_rng(3)
    pairs = _weights(rng, 64, [32, 16])
    tx, _ = _x(rng, 1, 64, "bfloat16")
    got = quant.dequant_matmul_group(tx, [t for _, t in pairs],
                                     impl="reference")
    for y, (_, twq) in zip(got, pairs):
        assert torch.equal(y, quant.dequant_matmul_reference(tx, twq))
    with pytest.raises(ValueError, match="impl"):
        quant.dequant_matmul_group(tx, [t for _, t in pairs], impl="flash")


def test_k5_groups_rule():
    """One launch for 2-3 weights at 1-2 rows of a CUDA tensor only."""
    x1 = torch.zeros((1, 1, 64), device="meta")
    x3 = torch.zeros((3, 1, 64), device="meta")
    cpu = torch.zeros((1, 1, 64))
    assert not quant.k5_groups(cpu, 3)  # no card: each member alone
    assert not quant.k5_groups(x1, 3)  # a meta tensor is no CUDA tensor
    fake = _Emulated.groups
    assert fake(x1, 3) and fake(x1, 2) and not fake(x1, 1)
    assert not fake(x1, 4) and not fake(x3, 2)


class _Emulated:
    """The card's K5 launch rule on CPU tensors: grouping as ``k5_groups``
    has it without the CUDA check, the grouped launch replaced by each
    member's plain product, and a count of the launches the card would
    make (grouped, and single products of 1..K5_MAX_ROWS rows)."""

    def __init__(self, monkeypatch, grouped=True):
        self.launches = []
        monkeypatch.setattr(quant, "k5_groups",
                            self.groups if grouped else self.never)
        monkeypatch.setattr(routed_lora, "k5_groups",
                            self.groups if grouped else self.never)
        monkeypatch.setattr(quant, "_k5_call", self.k5_call)
        for mod in (routed_lora, llama):
            monkeypatch.setattr(mod, "dequant_matmul", self.single)

    @staticmethod
    def groups(x, n):
        M = x.numel() // x.shape[-1]
        return 1 < n <= quant.K5_GROUP_MAX and 0 < M <= quant.K5_GROUP_ROWS

    @staticmethod
    def never(x, n):
        return False

    def k5_call(self, x, weights, out_dtype):
        self.launches.append(len(weights))
        return [quant.dequant_matmul_reference(x, wq, out_dtype)
                for wq in weights]

    def single(self, x, wq, out_dtype=None, impl="auto"):
        if impl == "auto" and 0 < x.numel() // x.shape[-1] \
                <= quant.K5_MAX_ROWS:
            self.launches.append(1)
        return quant.dequant_matmul(x, wq, out_dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_call_is_differentiable_through_x(monkeypatch, dtype):
    """The grouped launch's autograd Function (K5 forward emulated by the
    plain products): dL/dx, the members' ``_dequant_matmul_dx`` summed,
    against ``jax.vjp`` of the members' JAX products."""
    monkeypatch.setattr(quant, "_k5", lambda x2, ws, od: [
        quant.dequant_matmul_reference(x2, wq, od) for wq in ws])
    rng = np.random.default_rng(11)
    K, Ns = 96, [64, 32, 48]
    pairs = _weights(rng, K, Ns)
    tx, jx = _x(rng, 2, K, dtype)
    gs = [rng.normal(size=(2, 1, N)).astype(np.float32) for N in Ns]

    def jf(x):
        return [jquant.dequant_matmul(x, jwq, out_dtype=jnp.float32)
                for jwq, _ in pairs]
    _, vjp = jax.vjp(jf, jx)
    want = vjp([jnp.asarray(g) for g in gs])[0]
    tx.requires_grad_(True)
    ys = quant._k5_call(tx, [t for _, t in pairs], torch.float32)
    (got,) = torch.autograd.grad(ys, tx, [torch.from_numpy(g) for g in gs])
    assert got.dtype == tx.dtype
    assert _rel(got, want) <= TOL[dtype]


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _model(dtype, seed=0):
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16,
                           dtype=dtype)
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.05, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    jp = jquant.quantize_backbone(params)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype,B,routed", [
    ("float32", 1, True), ("float32", 1, False), ("float32", 2, True),
    ("float32", 2, False), ("float32", 3, True), ("bfloat16", 1, True),
    ("bfloat16", 2, False)])
def test_decode_step_grouped_equals_per_member_and_jax(monkeypatch, dtype,
                                                       B, routed):
    """A decode step of an int8 backbone with the card's launch rule
    emulated: grouped (q/k/v and gate/up one launch each at 1-2 rows)
    its logits are bit-equal to the per-member path's and within the
    logits tolerance of the JAX decode step, and it counts 4 launches a
    layer + the lm_head at 1-2 rows, 7 a layer + 1 at 3 (each member
    alone there, as without grouping)."""
    cfg, jp, tparams = _model(dtype)
    rng = np.random.default_rng(B)
    L, cache_len = 6, 12
    embeds = rng.normal(0, 1, (B, L, cfg.hidden_size)).astype(np.float32)
    route_ids = rng.choice((0, 2), size=(B, L)).astype(np.int32)
    lengths = np.array([L, L - 2, L - 1][:B], np.int32)
    seg = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    table = cfg.routing_table() if routed else None
    ttable = None if table is None else _t(table)
    next_tok = np.array([7, 11, 3][:B], np.int32)
    tdt, jdt = DTYPES[dtype]

    def step(grouped):
        with monkeypatch.context() as m:
            emu = _Emulated(m, grouped)
            _, cache = _prefill(tparams, _port(cfg), _t(embeds).to(tdt),
                                _t(route_ids), ttable, _t(seg), _t(lengths),
                                cache_len)
            del emu.launches[:]
            logits, _, _ = _decode_step(tparams, _port(cfg), cache,
                                        _t(next_tok), _t(lengths), ttable)
        return logits, emu.launches

    grouped, launches = step(True)
    per_member, single = step(False)
    n = cfg.num_hidden_layers
    assert torch.equal(grouped, per_member)
    assert single == [1] * (7 * n + 1)
    if B <= quant.K5_GROUP_ROWS:
        assert launches == [3, 1, 2, 1] * n + [1]
    else:
        assert launches == single

    j0, jcache = jgen._prefill(jp, cfg, jnp.asarray(embeds, jdt),
                               jnp.asarray(route_ids), table,
                               jnp.asarray(seg), jnp.asarray(lengths),
                               cache_len, "auto", False)
    want, _, _ = jgen._decode_step(jp, cfg, jcache, jnp.asarray(next_tok),
                                   jnp.asarray(lengths), table)
    want = np.asarray(want, np.float32)
    tol = LOGIT_TOL[dtype] * float(np.abs(want).max())
    np.testing.assert_allclose(grouped.float().numpy(), want, rtol=0,
                               atol=tol)


def test_forward_hidden_grouping_at_one_row_is_bit_equal(monkeypatch):
    """``forward_hidden`` over one position of one row (the shape of a
    batch-1 decode) with the emulated grouping and without: bit-equal
    hidden states, 4 launches a layer against 7."""
    cfg, _, tparams = _model("bfloat16", seed=4)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 1, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    outs = []
    for grouped in (True, False):
        with monkeypatch.context() as m:
            emu = _Emulated(m, grouped)
            h, _ = llama.forward_hidden(tparams, _port(cfg), x)
        outs.append((h, len(emu.launches)))
    n = cfg.num_hidden_layers
    assert torch.equal(outs[0][0], outs[1][0])
    assert (outs[0][1], outs[1][1]) == (4 * n, 7 * n)
