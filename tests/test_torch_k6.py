"""K6, the int8 product above K5_MAX_ROWS rows (``ops/quant.w8a16_gemm``,
``csrc/w8a16_gemm.cu``), on the CPU: its grid rule at every main-path
shape, the checks of its wrapper, the plain version against the JAX
package's ``dequant_matmul`` at prefill-sized row counts, and the port's
prefill, chunk, decode and train forward with the card's launch rule
emulated.

K6 has no CPU build (its card tests are in tests/test_torch_kernels_cuda.py).
The emulation (``_Card``) runs the real dispatch of ``quant.dequant_matmul``
and ``dequant_matmul_group`` on CPU tensors: ``_route.on_card`` says yes
for the products, and the launchers ``quant._k5``, ``quant._k6`` and
``quant._k7`` (the gradient through x) are replaced by the plain versions
of what they get,
each call counted as the launch the card would make.  So the launch
counts, the autograd Function and the results of the kernel path are
checked without a card.  fp32 x takes the plain product on every device
(the kernels take bf16 and fp16), so an fp32 model launches nothing.

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
from modelcompose_tpu_torch.core.prefill_graph import (_prefill,
                                                       _prefill_chunk_step)
from modelcompose_tpu_torch.ops import _route, quant

jgen = importlib.import_module("modelcompose_tpu.core.generate")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# The int8 products of the main path (K, N): Vicuna-7B's q/k/v/o, gate/up,
# down and lm_head, and the tp 2 and 4 shards' column and row splits.
SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
          (4096, 2048), (4096, 1024), (4096, 5504), (4096, 2752),
          (4096, 16000), (4096, 8000), (2048, 4096), (1024, 4096),
          (5504, 4096), (2752, 4096)]
# K6's rows on the main path: a tail chunk, a chunk and the smallest
# bucket, the EVA + ImageBind request, the vision pair, MCUB-4 in its
# bucket, the train batch; and 9, 37.
ROWS = [9, 37, 256, 512, 698, 2048, 3287, 3328, 4096]


def _raster(m_tiles, n_tiles, group):
    """The (row tile, column tile) of each tile in raster order, as the
    kernels compute it (K6's ``Units::at``, K7's blockIdx.x): groups of
    ``group`` row tiles, the group's row tiles walked under each column
    tile."""
    out = []
    for b in range(m_tiles * n_tiles):
        first = b // (group * n_tiles) * group
        here = min(m_tiles - first, group)
        r = b % (group * n_tiles)
        out.append((first + r % here, r // here))
    return out


# The clusters the plan may find on a card: an H100's nominal counts, and
# an uneven split of the SMs over its GPCs (fewer clusters of 2 and 4).
ACTIVE = {"nominal": quant._K6_ACTIVE,
          "uneven": {(rows, split): {1: 132, 2: 64, 4: 30}[split]
                     for rows, split in quant._K6_RATES}}


def _check_schedule(plan, M, K, N, active):
    """The schedule of ``plan`` covers y [M, N] once: each whole tile in
    one unit over every 64-deep step; each split tile in ``split`` units,
    one to each block of one cluster, their ranges partitioning the steps
    contiguously in rank order (k order), none empty; the tiles in raster
    order; each block within one unit of the others, and every block of a
    cluster with the same split units (they meet at its barriers)."""
    cols, step = quant._K6_COLS, quant._K6_STEP
    n_k = -(-K // step)
    assert plan.rows in {64, 128, 256} and plan.split in {1, 2, 4}
    assert (plan.rows, plan.split) in quant._K6_RATES
    assert (plan.m_tiles - 1) * plan.rows < M <= plan.m_tiles * plan.rows
    assert (plan.n_tiles - 1) * cols < N <= plan.n_tiles * cols
    assert 1 <= plan.group <= min(quant._K6_GROUP, plan.m_tiles)
    tiles = plan.m_tiles * plan.n_tiles
    blocks = plan.clusters * plan.split
    assert 1 <= plan.clusters <= active[plan.rows, plan.split]
    if plan.split == 1:
        assert plan.whole == tiles
    else:
        assert 0 <= plan.whole < tiles and plan.whole % blocks == 0
        assert n_k >= plan.split
    raster = _raster(plan.m_tiles, plan.n_tiles, plan.group)
    assert sorted(raster) == [(m, n) for m in range(plan.m_tiles)
                              for n in range(plan.n_tiles)]
    schedule = quant._k6_schedule(plan, K)
    assert len(schedule) == blocks
    seen = {}
    for b, units in enumerate(schedule):
        for mt, nt, k0, k1, part in units:
            seen.setdefault((mt, nt), []).append((part, k0, k1, b))
    assert sorted(seen) == sorted(raster)
    for t, tile in enumerate(raster):
        units = sorted(seen[tile], key=lambda u: (u[0] is not None, u[0]))
        if t < plan.whole:
            assert units == [(None, 0, n_k, units[0][3])]
            continue
        assert [u[0] for u in units] == list(range(plan.split))
        assert len({u[3] // plan.split for u in units}) == 1
        assert [u[3] % plan.split for u in units] == list(range(plan.split))
        assert units[0][1] == 0 and units[-1][2] == n_k
        assert all(a[2] == b[1] for a, b in zip(units, units[1:]))
        assert all(u[1] < u[2] for u in units)
    counts = [len(units) for units in schedule]
    assert max(counts) - min(counts) <= 1
    for c in range(plan.clusters):
        split_units = {sum(u[4] is not None for u in schedule[b])
                       for b in range(c * plan.split, (c + 1) * plan.split)}
        assert len(split_units) == 1


@pytest.mark.parametrize("active", sorted(ACTIVE))
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_k6_plan_covers_the_output(K, N, M, active):
    """The plan's schedule (``_k6_schedule``, the kernel's ``Units``
    mirrored) covers y [M, N] once, at every main-path shape and tp shard,
    on a card with the nominal clusters and on one with fewer clusters of
    2 and 4; the block and split are ones the kernel takes."""
    plan = quant._k6_plan(M, K, N, ACTIVE[active])
    _check_schedule(plan, M, K, N, ACTIVE[active])


@pytest.mark.parametrize("rows,split", sorted(quant._K6_RATES))
@pytest.mark.parametrize("M,K,N", [(300, 4104, 2752), (3400, 4104, 4112),
                                   (9, 344, 48), (3328, 11008, 4096)])
def test_k6_every_schedule_covers_the_output(rows, split, M, K, N):
    """Each (rows, split) the kernel takes, forced, at ragged M, N and K:
    every tile split (300 rows) or a tail after whole waves (3,400 rows)."""
    active = quant._K6_ACTIVE
    blocks = [(rows, split)]
    tiles = -(-M // rows) * -(-N // quant._K6_COLS)
    if split > 1 and (tiles % (active[rows, split] * split) == 0
                      or -(-K // quant._K6_STEP) < split
                      or K > quant._K6_SPLIT_MAX_K[split]):
        with pytest.raises(ValueError, match="no schedule"):
            quant._k6_plan(M, K, N, active, blocks)
        return
    plan = quant._k6_plan(M, K, N, active, blocks)
    assert (plan.rows, plan.split) == (rows, split)
    _check_schedule(plan, M, K, N, active)


def test_k6_plan_picks_by_waves():
    """256-row blocks at prefill sizes; a 512-row chunk of a 4096-wide
    product splits K over clusters of 256-row blocks (64 tiles: half the
    card as whole tiles), and the 3,328-row bucket's q/k/v/o splits its
    last, partial wave (416 tiles: 3 whole waves and a tail of 20)."""
    chunk = quant._k6_plan(512, 4096, 4096)
    assert (chunk.rows, chunk.whole) == (256, 0) and chunk.split > 1
    bucket = quant._k6_plan(3328, 4096, 4096)
    assert bucket.rows == 256 and bucket.split > 1
    assert 0 < bucket.whole < bucket.m_tiles * bucket.n_tiles
    assert quant._k6_plan(4096, 11008, 4096).rows == 256
    assert quant._k6_plan(8192, 4096, 4096).rows == 256


@pytest.mark.parametrize("active", sorted(ACTIVE))
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_k6_plan_splits_only_short_k(K, N, M, active):
    """A split's partial sums move an fp32 output by a share of max |y|
    that grows with K: the plan splits only up to ``_K6_SPLIT_MAX_K`` (so
    never down's K = 11,008), and the limits keep the largest move the
    card showed, scaled linearly in K from K = 4,096 (3.2e-6 at split 2,
    4.0e-6 at 4), within half the 1e-5 tolerance."""
    plan = quant._k6_plan(M, K, N, ACTIVE[active])
    if plan.split > 1:
        assert K <= quant._K6_SPLIT_MAX_K[plan.split]
    for split, worst in ((2, 3.2e-6), (4, 4.0e-6)):
        assert worst * quant._K6_SPLIT_MAX_K[split] / 4096 <= 0.5e-5
    assert quant._k6_plan(512, 11008, 4096, ACTIVE[active]).split == 1


def _emulate(x, wq, plan, K):
    """y of K6's schedule in plain PyTorch: each unit's fp32 product over
    its k range (the int8 and half values exact in fp32), a whole tile's
    scaled as it is, a split tile's partials summed in rank order (k order)
    and then scaled, as the kernel's epilogue and cluster sum do.  Every
    output is written exactly once."""
    xf, qf = x.float(), wq["q"].float()
    sc = wq["scale"].reshape(-1)
    M, N = xf.shape[0], qf.shape[1]
    y = torch.full((M, N), float("nan"))
    parts = {}
    for units in quant._k6_schedule(plan, K):
        for mt, nt, k0, k1, part in units:
            rs = slice(mt * plan.rows, min(M, (mt + 1) * plan.rows))
            cs = slice(nt * quant._K6_COLS, min(N, (nt + 1) * quant._K6_COLS))
            ks = slice(k0 * quant._K6_STEP, min(K, k1 * quant._K6_STEP))
            p = xf[rs, ks] @ qf[ks, cs]
            if part is None:
                assert torch.isnan(y[rs, cs]).all()
                y[rs, cs] = p * sc[cs]
            else:
                parts.setdefault((rs.start, cs.start), {})[part] = (rs, cs, p)
    for tile in parts.values():
        rs, cs, total = tile[0]
        for r in range(1, len(tile)):
            total = total + tile[r][2]
        assert torch.isnan(y[rs, cs]).all()
        y[rs, cs] = total * sc[cs]
    assert not torch.isnan(y).any()
    return y


# Main-path products scaled down (the 512-row chunk of a narrow layer, the
# 3,328 bucket's tail in miniature), ragged M, N and K, with few clusters
# so that whole waves and split tails both occur.
EMULATED = [(512, 512, 512), (700, 1000, 272), (9, 344, 48), (300, 4104, 144),
            (1100, 768, 400)]
FEW = {(rows, split): {1: 8, 2: 3, 4: 2}[split]
       for rows, split in quant._K6_RATES}


@pytest.mark.parametrize("blocks", [None] + [[b] for b in sorted(
    quant._K6_RATES)])
@pytest.mark.parametrize("M,K,N", EMULATED)
def test_k6_schedule_arithmetic_matches_jax(M, K, N, blocks):
    """K6's arithmetic on its schedule (``_emulate``: fp32 partials per k
    range, summed in rank order, scaled), on bf16 x, against the JAX
    ``dequant_matmul`` and ``dequant_matmul_reference`` at fp32 within
    1e-5 of max |y|: the split changes only the summation order."""
    try:
        plan = quant._k6_plan(M, K, N, FEW, blocks)
    except ValueError:
        assert blocks is not None and blocks[0][1] > 1  # nothing to split
        return
    rng = np.random.default_rng(M + K + N)
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = _emulate(tx, twq, plan, K).numpy()
    want = np.asarray(jquant.dequant_matmul(
        jnp.asarray(x, jnp.bfloat16), jwq, out_dtype=jnp.float32))
    ref = quant.dequant_matmul_reference(tx, twq, torch.float32).numpy()
    for other in (want, ref):
        assert np.abs(got - other).max() / np.abs(other).max() <= 1e-5


@pytest.mark.parametrize("M,K,N", [(512, 4100, 4096), (512, 4096, 4104),
                                   (512, 4096, 40), (0, 4096, 4096),
                                   (512, 0, 4096)])
def test_k6_plan_refuses_misaligned(M, K, N):
    """K % 8 and N % 16 (TMA's 16-byte row strides), and empty shapes."""
    with pytest.raises(ValueError, match="K6"):
        quant._k6_plan(M, K, N)


def _int8(rng, K, N):
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    jwq = jquant.quantize_int8(jnp.asarray(w))
    return jwq, {k: torch.from_numpy(np.array(v)) for k, v in jwq.items()}


@pytest.mark.parametrize("case", ["x_fp32", "n_not_16", "k_not_8",
                                  "q_not_contiguous", "scale_bf16",
                                  "scale_count"])
def test_k6_checks_raise(case):
    """What K6 does not take raises before any launch."""
    rng = np.random.default_rng(1)
    K, N = 64, 48
    _, wq = _int8(rng, K, N)
    x = torch.zeros((16, K), dtype=torch.bfloat16)
    q, scale = wq["q"], wq["scale"]
    if case == "x_fp32":
        x = x.float()
    elif case == "n_not_16":
        q, scale = q[:, :40].contiguous(), scale[:, :40].contiguous()
    elif case == "k_not_8":
        x, q = x[:, :60], q[:60].contiguous()
    elif case == "q_not_contiguous":
        q = torch.zeros((N, K), dtype=torch.int8).t()
    elif case == "scale_bf16":
        scale = scale.to(torch.bfloat16)
    elif case == "scale_count":
        scale = scale[:, :32].contiguous()
    with pytest.raises((TypeError, ValueError)):
        quant._check_k6_inputs(x, q, scale)


@pytest.mark.parametrize("fn", ["reference", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [9, 37, 512])
@pytest.mark.parametrize("K,N,out", [(128, 128, None), (344, 48, None),
                                     (64, 272, "float32")])
def test_dequant_matmul_at_prefill_rows_matches_jax(K, N, out, M, dtype, fn):
    """``dequant_matmul_reference`` (and ``dequant_matmul`` on a CPU
    tensor, which takes it) at K6's row counts against the JAX
    ``dequant_matmul``; no launch is counted."""
    rng = np.random.default_rng(K + N + M)
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    t_out = out and getattr(torch, out)
    n5, n6 = quant.dequant_matmul.launches, quant.w8a16_gemm.launches
    f = quant.dequant_matmul_reference if fn == "reference" \
        else quant.dequant_matmul
    got = f(tx, twq, out_dtype=t_out)
    assert (quant.dequant_matmul.launches, quant.w8a16_gemm.launches) == (
        n5, n6)
    want = np.asarray(jnp.asarray(jquant.dequant_matmul(
        jx, jwq, out_dtype=out and getattr(jnp, out)), jnp.float32))
    assert got.dtype == (t_out or tdt)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= TOL["float32" if out else dtype]


class _Card:
    """The card's launch rule on CPU tensors: ``_route.on_card`` says yes
    for the products,
    and K5's and K6's launchers compute the plain products of the weights
    they are given, K7's the plain dL/dx, each call counted as one launch
    ("K5", "K6" or "K7")."""

    def __init__(self, monkeypatch):
        self.launches = []
        monkeypatch.setattr(_route, "on_card",
                            lambda x, kernels: kernels == "products")
        monkeypatch.setattr(quant, "_k5", self.launcher("K5"))
        monkeypatch.setattr(quant, "_k6", self.launcher("K6"))
        monkeypatch.setattr(quant, "_k7", self.k7)

    def k7(self, g2, q, scale, dtype):
        self.launches.append("K7")
        return quant._dequant_matmul_dx(g2, q, scale, dtype)

    def launcher(self, name):
        def run(x2, weights, out_dtype):
            assert (x2.shape[0] <= quant.K5_MAX_ROWS) == (name == "K5")
            self.launches.append(name)
            return [quant.dequant_matmul_reference(x2, wq, out_dtype)
                    for wq in weights]
        return run

    def count(self, name):
        return self.launches.count(name)


def _port(cfg):
    return PortConfig.from_dict(cfg.to_dict())


def _model(dtype, seed=0, **cfg_kw):
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16,
                           dtype=dtype, **cfg_kw)
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


@pytest.mark.parametrize("dtype,B,L", [("float32", 1, 12), ("float32", 2, 9),
                                       ("bfloat16", 2, 6)])
def test_forward_above_eight_rows_runs_k6(monkeypatch, dtype, B, L):
    """``forward_hidden`` over more than 8 rows (B x L) with the card's rule
    emulated: 7 K6 launches a layer and no K5 launch (none at all for fp32
    activations, which take the plain product), the hidden states
    bit-equal to the CPU path's; its logits (one more K6 launch for the
    lm_head over every position) within the logits tolerance of the JAX
    ``forward``."""
    cfg, jp, tparams = _model(dtype)
    rng = np.random.default_rng(B * L)
    embeds = rng.normal(0, 1, (B, L, cfg.hidden_size)).astype(np.float32)
    route_ids = rng.choice((0, 2), size=(B, L)).astype(np.int32)
    table = cfg.routing_table()
    tdt, jdt = DTYPES[dtype]
    kw = dict(route_ids=_t(route_ids), routing_table=_t(table))
    plain, _ = llama.forward_hidden_routed(tparams, _port(cfg),
                                           _t(embeds).to(tdt), **kw)
    with monkeypatch.context() as m:
        card = _Card(m)
        hidden, _ = llama.forward_hidden_routed(tparams, _port(cfg),
                                                _t(embeds).to(tdt), **kw)
        n = cfg.num_hidden_layers if dtype != "float32" else 0
        assert (card.count("K6"), card.count("K5")) == (7 * n, 0)
        logits = llama.logits_from_hidden(tparams, hidden)
        assert (card.count("K6"), card.count("K5")) == (
            7 * n + (dtype != "float32"), 0)
    assert torch.equal(hidden, plain)
    want, _ = jllama.forward(jp, cfg, jnp.asarray(embeds, jdt),
                             route_ids=jnp.asarray(route_ids),
                             routing_table=table)
    want = np.asarray(want, np.float32)
    tol = LOGIT_TOL[dtype] * float(np.abs(want).max())
    np.testing.assert_allclose(logits.float().numpy(), want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunk_step_runs_k6(monkeypatch, kv_quant):
    """A 16-row chunk of a chunked prefill with the card's rule emulated:
    7 K6 launches a layer, no K5 launch, the chunk's hidden states and
    cache bit-equal to the CPU path's."""
    cfg, _, tparams = _model("bfloat16", seed=2)
    rng = np.random.default_rng(2)
    embeds = _t(rng.normal(0, 1, (1, 16, cfg.hidden_size)).astype(
        np.float32)).to(torch.bfloat16)
    route = _t(rng.choice((0, 2), size=(1, 16)).astype(np.int32))
    table = _t(cfg.routing_table())
    outs = []
    for emulated in (False, True):
        cache = llama.KVCache.zeros(_port(cfg), 1, 48, quantized=kv_quant,
                                    device="cpu")
        with monkeypatch.context() as m:
            card = _Card(m) if emulated else None
            h = _prefill_chunk_step(tparams, _port(cfg), cache, embeds, route,
                                    table, 16)
        outs.append((h, cache))
    n = cfg.num_hidden_layers
    assert (card.count("K6"), card.count("K5")) == (7 * n, 0)
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1].tensors(),
                                                 outs[1][1].tensors()))


@pytest.mark.parametrize("B", [1, 2])
def test_decode_step_stays_on_k5(monkeypatch, B):
    """With bf16 activations a prefill of more than 8 rows runs K6 (and K5
    for the last position's lm_head, B rows), then a 1-2-row decode step
    runs 4 K5 launches a layer + the lm_head (q/k/v and gate/up grouped)
    and no K6 launch, its logits bit-equal to the CPU path's and matching
    the JAX bf16 decode step; with fp32 activations (the plain product, no
    launch) the decode step's logits match the JAX fp32 decode step."""
    cfg, jp, tparams = _model("float32", seed=3)
    bcfg, bjp, bparams = _model("bfloat16", seed=3)
    rng = np.random.default_rng(B + 3)
    L, cache_len = 10, 16
    embeds = rng.normal(0, 1, (B, L, cfg.hidden_size)).astype(np.float32)
    route_ids = rng.choice((0, 2), size=(B, L)).astype(np.int32)
    lengths = np.array([L, L - 3][:B], np.int32)
    seg = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    table = cfg.routing_table()
    next_tok = np.array([7, 11][:B], np.int32)
    n = cfg.num_hidden_layers

    def run(params, c, dtype, card=None):
        """(decode logits, the prefill's launches)."""
        _, cache = _prefill(params, _port(c), _t(embeds).to(dtype),
                            _t(route_ids), _t(table), _t(seg), _t(lengths),
                            cache_len)
        prefill = None if card is None else list(card.launches)
        if card is not None:
            del card.launches[:]
        logits, _, _ = _decode_step(params, _port(c), cache, _t(next_tok),
                                    _t(lengths), _t(table))
        return logits, prefill
    with monkeypatch.context() as m:
        card = _Card(m)
        logits, prefill = run(tparams, cfg, torch.float32, card)
        assert prefill == [] and card.launches == []
        half, prefill = run(bparams, bcfg, torch.bfloat16, card)
        assert prefill == ["K6"] * (7 * n) + ["K5"]
        assert (card.count("K5"), card.count("K6")) == (4 * n + 1, 0)
    assert torch.equal(half, run(bparams, bcfg, torch.bfloat16)[0])
    for got, p, c, dtype in ((logits, jp, cfg, "float32"),
                             (half, bjp, bcfg, "bfloat16")):
        jdt = DTYPES[dtype][1]
        _, jcache = jgen._prefill(p, c, jnp.asarray(embeds, jdt),
                                  jnp.asarray(route_ids), table,
                                  jnp.asarray(seg), jnp.asarray(lengths),
                                  cache_len, "auto", False)
        want, _, _ = jgen._decode_step(p, c, jcache, jnp.asarray(next_tok),
                                       jnp.asarray(lengths), table)
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=LOGIT_TOL[dtype]
                                   * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_is_differentiable_through_x(monkeypatch, dtype):
    """K6's autograd Function (its forward emulated by the plain product,
    its dL/dx by K7's plain version; fp32 x takes the plain product and
    autograd): dL/dx against ``jax.vjp`` of the JAX ``dequant_matmul``."""
    rng = np.random.default_rng(12)
    K, N, M = 96, 80, 24
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(2, M // 2, K)).astype(np.float32)
    g = rng.normal(size=(2, M // 2, N)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    _, vjp = jax.vjp(lambda a: jquant.dequant_matmul(
        a, jwq, out_dtype=jnp.float32), jnp.asarray(x, jdt))
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g))[0], jnp.float32))
    with monkeypatch.context() as m:
        card = _Card(m)
        tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
        y = quant.dequant_matmul(tx, twq, out_dtype=torch.float32)
        (got,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
        assert card.launches == ([] if dtype == "float32" else ["K6", "K7"])
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= TOL[dtype]


def test_remat_train_forward_runs_k6_twice(monkeypatch):
    """The int8-base train forward under remat with the card's rule
    emulated: K6 runs 7 times a layer forward and again in each layer's
    recompute during the backward (and K7 once an int8 product for its
    dL/dx), and the gradient of the embeddings is bit-equal to the CPU
    path's."""
    cfg, _, tparams = _model("bfloat16", seed=5, remat=True)
    rng = np.random.default_rng(5)
    embeds = _t(rng.normal(0, 1, (2, 8, cfg.hidden_size)).astype(
        np.float32)).to(torch.bfloat16)
    n = cfg.num_hidden_layers
    grads = []
    for emulated in (False, True):
        with monkeypatch.context() as m:
            card = _Card(m) if emulated else None
            x = embeds.clone().requires_grad_(True)
            h, _ = llama.forward_hidden(tparams, _port(cfg), x)
            if card is not None:
                assert card.launches == ["K6"] * (7 * n)
            (dx,) = torch.autograd.grad(h.float().square().sum(), x)
            if card is not None:
                assert (card.count("K6"), card.count("K7")) == (14 * n, 7 * n)
        grads.append(dx)
    assert torch.equal(grads[0], grads[1])
