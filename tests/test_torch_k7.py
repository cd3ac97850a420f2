"""K7, the gradient through x of the int8 products (``ops/quant.w8a16_dx``,
``csrc/w8a16_dx.cu``), and the routing of x by its dtype, on the CPU:

- (a) fp32 x on an int8 weight, with the card's launch rule emulated,
  takes the plain product on every device (no K5, K6 or K7 launch), as
  the JAX ``dequant_matmul`` computes ``x @ q.astype(x.dtype)`` for any
  float x, at 1, 2, 9 and 37 rows, one weight and a group;
- (b) K7's plain version (``_dequant_matmul_dx``, and ``w8a16_dx`` on a CPU
  tensor) against ``jax.vjp`` of the JAX ``dequant_matmul`` for fp32 and
  bf16 cotangents, bf16 and fp16 x, at the shape ratios of Vicuna-7B's
  q/k/v/o, gate/up, down and lm_head at narrow widths; K7's two passes in
  their plain form (``_scale_cotangent``, then the product) bit-equal to
  it, and against ``jax.vjp`` for fp32, bf16 and fp16 cotangents;
- (c) the int8-base (QLoRA) train step under remat with the card's rule
  emulated: K6 14 times a layer and twice a loss chunk (forward and
  recompute), K7 7 times a layer and once a loss chunk, counted exactly,
  and the step's loss, leaves and moments bit-equal to the CPU path's;
  K7's grid rule (the product's block picked by its waves) and the
  wrapper's checks.

K7 has no CPU build (its card tests are in tests/test_torch_kernels_cuda.py).
The emulation is tests/test_torch_k6.py's ``_Card`` with a counting K7
launcher: ``_route.on_card`` says yes for the products, and
``quant._k5``, ``quant._k6`` and ``quant._k7`` compute their plain
versions, each call counted as the launch the card would make.

Inputs are seeded numpy arrays handed to both packages.  Tolerances,
relative to max |JAX|: 1e-5 for an fp32 product (int8 and fp32 values, the
summation order alone); 2e-2 for a gradient in bf16 or fp16 (the port
rounds the scaled cotangent to x's type before the product, as a TPU's
DEFAULT-precision dot does, where XLA on a CPU keeps it in fp32, and dx is
rounded once).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.ops import quant as jquant

from modelcompose_tpu_torch.config import tiny_test_config
from modelcompose_tpu_torch.core.packing import (IGNORE_INDEX,
                                                 MODAL_TOKEN_INDEXES)
from modelcompose_tpu_torch.models.model import MultimodalLM
from modelcompose_tpu_torch.ops import _route, quant
from modelcompose_tpu_torch.train import train_multimodal as entry
from modelcompose_tpu_torch.train import trainer

F32_TOL = 1e-5
HALF_TOL = 2e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# Vicuna-7B's int8 products (K, N) narrowed 64x, ratios kept: q/k/v/o,
# gate/up, down and the lm_head (32,000 / 64 = 500, rounded to 16).
NARROW = {"qkvo": (64, 64), "gate_up": (64, 176), "down": (176, 64),
          "lm_head": (64, 496)}


def _int8(rng, K, N):
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    jwq = jquant.quantize_int8(jnp.asarray(w))
    return jwq, {k: torch.from_numpy(np.array(v)) for k, v in jwq.items()}


class _Card:
    """The card's launch rule on CPU tensors (tests/test_torch_k6.py's, with
    K7): ``_route.on_card`` says yes for the products, and the launchers
    of K5, K6 and K7
    compute their plain versions, each call counted as one launch."""

    def __init__(self, monkeypatch):
        self.launches = []
        monkeypatch.setattr(_route, "on_card",
                            lambda x, kernels: kernels == "products")
        monkeypatch.setattr(quant, "_k5", self.launcher("K5"))
        monkeypatch.setattr(quant, "_k6", self.launcher("K6"))
        monkeypatch.setattr(quant, "_k7", self.k7)

    def launcher(self, name):
        def run(x2, weights, out_dtype):
            assert x2.dtype in (torch.bfloat16, torch.float16)
            self.launches.append(name)
            return [quant.dequant_matmul_reference(x2, wq, out_dtype)
                    for wq in weights]
        return run

    def k7(self, g2, q, scale, dtype):
        quant._check_k7_inputs(g2, q, scale, dtype)
        self.launches.append("K7")
        return quant._dequant_matmul_dx(g2, q, scale, dtype)

    def count(self, name):
        return self.launches.count(name)


# ---------------------------------------------------------------------------
# (a) fp32 x takes the plain product on every device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("M", [1, 2, 9, 37])
def test_fp32_x_takes_the_plain_product(monkeypatch, M, out):
    """fp32 x with the card's rule emulated: no kernel launch, the result
    (fp32) within 1e-5 of the JAX ``dequant_matmul``'s, and its gradient
    through x (autograd of the plain product, no K7) within 1e-5 of
    ``jax.vjp``'s."""
    rng = np.random.default_rng(M)
    K, N = 96, 80
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    g = rng.normal(size=(M, N)).astype(np.float32)
    j_out = out and getattr(jnp, out)
    want, vjp = jax.vjp(lambda a: jquant.dequant_matmul(a, jwq, j_out),
                        jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    with monkeypatch.context() as m:
        card = _Card(m)
        assert not quant.k5_groups(torch.zeros((M, K)), 3)
        tx = torch.from_numpy(x).requires_grad_(True)
        got = quant.dequant_matmul(tx, twq, out_dtype=out and getattr(
            torch, out))
        (dx,) = torch.autograd.grad(got, tx, torch.from_numpy(g))
        assert card.launches == []
    want = np.asarray(want)
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - want).max() \
        <= F32_TOL * np.abs(want).max()
    assert np.abs(dx.numpy() - want_dx).max() \
        <= F32_TOL * np.abs(want_dx).max()


@pytest.mark.parametrize("M", [1, 2, 9, 37])
def test_fp32_x_group_takes_the_plain_products(monkeypatch, M):
    """A group (q/k/v) of fp32 x with the card's rule emulated: no grouped
    K5 launch at 1-2 rows and no kernel at all, each member within 1e-5 of
    the JAX ``dequant_matmul``'s."""
    rng = np.random.default_rng(M + 40)
    K = 64
    pairs = [_int8(rng, K, N) for N in (64, 32, 32)]
    x = rng.normal(size=(1, M, K)).astype(np.float32)
    with monkeypatch.context() as m:
        card = _Card(m)
        got = quant.dequant_matmul_group(torch.from_numpy(x),
                                         [t for _, t in pairs],
                                         out_dtype=torch.float32)
        assert card.launches == []
    for y, (jwq, _) in zip(got, pairs):
        want = np.asarray(jquant.dequant_matmul(jnp.asarray(x), jwq,
                                                jnp.float32))
        assert np.abs(y.numpy() - want).max() <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_x_still_launches(monkeypatch, dtype):
    """The dtype rule routes only other float types: bf16 and fp16 x still
    launch K5 at 1 row, K6 at 9 and K7 for each gradient."""
    rng = np.random.default_rng(7)
    _, twq = _int8(rng, 64, 48)
    tdt = DTYPES[dtype][0]
    with monkeypatch.context() as m:
        card = _Card(m)
        for M in (1, 9):
            x = torch.from_numpy(rng.normal(size=(M, 64)).astype(
                np.float32)).to(tdt).requires_grad_(True)
            y = quant.dequant_matmul(x, twq, out_dtype=torch.float32)
            torch.autograd.grad(y.sum(), x)
        assert card.launches == ["K5", "K7", "K6", "K7"]


# ---------------------------------------------------------------------------
# (b) K7's plain version against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", sorted(NARROW))
def test_k7_plain_matches_jax_vjp(shape, x_dtype, g_dtype, fn):
    """dL/dx for a cotangent in fp32 (the routed products', the logits')
    or in x's type: ``_dequant_matmul_dx`` (``fn`` plain) and ``w8a16_dx``
    on a CPU tensor (``fn`` wrapper, which takes it; leading axes kept)
    against ``jax.vjp`` of the JAX ``dequant_matmul``, in x's type."""
    K, N = NARROW[shape]
    rng = np.random.default_rng(K + N)
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(2, 19, K)).astype(np.float32)
    g = rng.normal(size=(2, 19, N)).astype(np.float32)
    tdt, jdt = DTYPES[x_dtype]
    gdt, jgdt = DTYPES[g_dtype]
    out = jnp.float32 if g_dtype == "float32" else None
    g_in = g if g_dtype == "float32" else np.array(
        jnp.asarray(g, jgdt).astype(jnp.float32))
    if g_dtype != "float32" and x_dtype != g_dtype:
        out = jgdt  # a half result of another half type
    _, vjp = jax.vjp(lambda a: jquant.dequant_matmul(a, jwq, out),
                     jnp.asarray(x, jdt))
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g_in, out or jdt))[0],
                                  jnp.float32))
    tg = torch.from_numpy(g_in).to(gdt)
    n7 = quant.w8a16_dx.launches
    if fn == "plain":
        got = quant._dequant_matmul_dx(tg.reshape(-1, N), twq["q"],
                                       twq["scale"], tdt).reshape(2, 19, K)
    else:
        got = quant.w8a16_dx(tg, twq, tdt)
    assert quant.w8a16_dx.launches == n7  # the CPU launches nothing
    assert got.dtype == tdt and got.shape == (2, 19, K)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= HALF_TOL


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float16"])
def test_k7_two_passes_equal_the_plain_dx(x_dtype, g_dtype):
    """K7's two passes in their plain form, ``_scale_cotangent`` and then
    the fp32-accumulated product with the exact int8 weight, equal
    ``_dequant_matmul_dx`` (and ``w8a16_dx`` on a CPU tensor) bit for bit,
    at every cotangent and x type, at the lm_head's shape ratio with a
    ragged row count; the scaled cotangent is one rounding of the fp32
    product."""
    K, N = NARROW["lm_head"]
    rng = np.random.default_rng(11)
    _, twq = _int8(rng, K, N)
    tdt, gdt = DTYPES[x_dtype][0], DTYPES[g_dtype][0]
    g = torch.from_numpy(rng.normal(size=(37, N)).astype(np.float32)).to(gdt)
    gs = quant._scale_cotangent(g, twq["scale"], tdt)
    assert gs.dtype == tdt and gs.shape == (37, N)
    assert torch.equal(gs, (g.float() * twq["scale"][0]).to(tdt))
    two = quant._mm_f32(gs, twq["q"].to(tdt).t()).to(tdt)
    assert torch.equal(two, quant._dequant_matmul_dx(g, twq["q"],
                                                     twq["scale"], tdt))
    assert torch.equal(two, quant.w8a16_dx(g, twq, tdt))


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("x_dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("shape", ["qkvo", "down"])
def test_k7_two_passes_match_jax_vjp(shape, x_dtype, g_dtype):
    """The two passes (``_scale_cotangent``, then the product) against
    ``jax.vjp`` of the JAX ``dequant_matmul`` for each cotangent type (fp32:
    the routed products' and the logits'; bf16 or fp16: a half result)
    and each x type, within 2e-2 of max |JAX| in x's type."""
    K, N = NARROW[shape]
    rng = np.random.default_rng(K + 3 * N)
    jwq, twq = _int8(rng, K, N)
    x = rng.normal(size=(2, 19, K)).astype(np.float32)
    g = rng.normal(size=(2, 19, N)).astype(np.float32)
    tdt, jdt = DTYPES[x_dtype]
    gdt, jgdt = DTYPES[g_dtype]
    out = jnp.float32 if g_dtype == "float32" else jgdt
    g_in = np.array(jnp.asarray(g, jgdt).astype(jnp.float32))
    _, vjp = jax.vjp(lambda a: jquant.dequant_matmul(a, jwq, out),
                     jnp.asarray(x, jdt))
    want = np.asarray(jnp.asarray(vjp(jnp.asarray(g_in, out))[0],
                                  jnp.float32))
    tg = torch.from_numpy(g_in).to(gdt).reshape(-1, N)
    gs = quant._scale_cotangent(tg, twq["scale"], tdt)
    got = quant._mm_f32(gs, twq["q"].to(tdt).t()).to(tdt).reshape(2, 19, K)
    assert got.dtype == tdt
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= HALF_TOL


def test_k7_group_backward_sums_members(monkeypatch):
    """A group's backward (q/k/v at 2 rows, one grouped K5 launch
    forward) runs K7 once a member and sums their dx in order, bit-equal
    to the members' plain products differentiated one by one."""
    rng = np.random.default_rng(3)
    K = 64
    ws = [_int8(rng, K, N)[1] for N in (64, 32, 32)]
    x = torch.from_numpy(rng.normal(size=(2, K)).astype(np.float32)).to(
        torch.bfloat16)
    gs = [torch.from_numpy(rng.normal(size=(2, N)).astype(np.float32))
          for N in (64, 32, 32)]
    with monkeypatch.context() as m:
        card = _Card(m)
        xr = x.clone().requires_grad_(True)
        ys = quant.dequant_matmul_group(xr, ws, out_dtype=torch.float32)
        (got,) = torch.autograd.grad(ys, xr, gs)
        assert card.launches == ["K5", "K7", "K7", "K7"]
    want = None
    for w, g in zip(ws, gs):
        xr = x.clone().requires_grad_(True)
        (d,) = torch.autograd.grad(quant.dequant_matmul_reference(
            xr, w, torch.float32), xr, g)
        want = d if want is None else want + d
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) the int8-base train step, K7's grid rule and checks
# ---------------------------------------------------------------------------

def _qlora(seed=0, n_layers=2):
    """A tiny bf16 vision model under remat with its base quantized as
    ``build_model(--quantize_frozen_base True)`` does, a batch of two
    image + text samples in the 16 bucket, and the QLoRA recipe's loss
    chunks and bf16 first moments."""
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           local_prefix_tokens=1, local_suffix_tokens=1,
                           dtype="bfloat16", remat=True,
                           num_hidden_layers=n_layers)
    tm = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(seed),
                                  "cpu")
    tm.params = quant.quantize_backbone(tm.params)
    img = MODAL_TOKEN_INDEXES["vision"]
    rs = np.random.RandomState(seed)
    col = {"input_ids": [np.array([1, img, 7, 8, 9]),
                         np.array([1, 5, img, 10, 11, 12])],
           "labels": [np.array([IGNORE_INDEX, IGNORE_INDEX, 7, 8, 9]),
                      np.array([IGNORE_INDEX] * 3 + [10, 11, 12])],
           "modal_inputs": {"vision": rs.rand(2, 28, 28, 3).astype(
               np.float32)}}
    batch, layout = entry.make_batch(tm, col, buckets=(16,))
    tc = trainer.TrainConfig(loss_chunk=8, adam_mu_dtype="bfloat16",
                             warmup_ratio=0.0, learning_rate=5e-3)
    return cfg, tm, batch, layout, tc


def _snapshot(state, tx):
    leaves = {p: t.detach().clone()
              for p, t in trainer.tree_leaves(state.params) if tx.trains(p)}
    moments = {(m, p): t.clone() for m in ("mu", "nu")
               for p, t in state.opt_state[m].items()}
    return leaves, moments


@pytest.mark.parametrize("graphs", [False, True])
def test_int8_base_train_step_runs_k6_and_k7(monkeypatch, graphs):
    """Two int8-base train steps under remat, with the card's rule
    emulated: each runs K6 14 times a layer (forward and recompute) + 2 a
    loss chunk (the lm_head's forward and recompute) and K7 7 times a
    layer + 1 a chunk, no K5; the losses, the trainable leaves and the
    Adam moments (bf16 mu) bit-equal to the CPU path's.  ``graphs`` sends
    the step through ``TrainStepGraph`` (eager on the CPU, through its
    static batch)."""
    runs = []
    for emulated in (False, True):
        cfg, tm, batch, layout, tc = _qlora()
        tx, _ = trainer.make_optimizer(cfg, tc, {
            "backbone": tm.params, "projectors": tm.projectors})
        state = trainer.init_train_state(cfg, tc, tm.params, tm.projectors,
                                         tx=tx)
        with monkeypatch.context() as m:
            if graphs:
                m.setattr(trainer, "use_graphs",
                          lambda graphs, device, tx: True)
            card = _Card(m) if emulated else None
            step = trainer.make_train_step(cfg, tc, tx)
            losses = []
            for _ in range(2):
                if card is not None:
                    del card.launches[:]
                state, loss = step(state, batch, layout)
                losses.append(float(loss))
                if card is not None:
                    n = cfg.num_hidden_layers
                    chunks = batch["token_ids"].shape[1] // tc.loss_chunk
                    assert (card.count("K6"), card.count("K7"),
                            card.count("K5")) == (14 * n + 2 * chunks,
                                                  7 * n + chunks, 0)
            if graphs:
                assert len(step.graphs) == 1
        runs.append((losses, *_snapshot(state, tx)))
    (l0, leaves0, mom0), (l1, leaves1, mom1) = runs
    assert l0 == l1 and np.isfinite(l0).all()
    assert leaves0.keys() == leaves1.keys() and mom0.keys() == mom1.keys()
    for p in leaves0:
        assert torch.equal(leaves0[p], leaves1[p]), p
    for k in mom0:
        assert torch.equal(mom0[k], mom1[k]), k
    assert all(mom0[("mu", p)].dtype == torch.bfloat16 for p in leaves0)


@pytest.mark.parametrize("M,K,N", [(8192, 4096, 4096), (8192, 4096, 11008),
                                   (8192, 11008, 4096), (32768, 4096, 11008),
                                   (1024, 4096, 32000), (512, 4096, 32000),
                                   (256, 4096, 32000), (4096, 4096, 32000),
                                   (1, 4096, 4096), (37, 344, 48)])
def test_k7_plan_covers_dx(M, K, N):
    """K7's product grid covers dx [M, K] once: blocks of 256 or 128 rows
    of the scaled cotangent (the two the kernel takes) by 128 dx columns;
    the last row and column tiles masked at M and K; K6's raster
    (tests/test_torch_k6._raster) visits every tile once."""
    from test_torch_k6 import _raster
    plan = quant._k7_plan(M, K, N)
    rows, m_tiles, k_tiles, group = plan
    assert rows in quant._K7_RATES and set(quant._K7_RATES) == {256, 128}
    assert (m_tiles - 1) * rows < M <= m_tiles * rows
    assert (k_tiles - 1) * quant._K7_COLS < K <= k_tiles * quant._K7_COLS
    assert quant._K7_COLS == 128
    assert 1 <= group <= min(quant._K7_GROUP, m_tiles)
    assert sorted(_raster(m_tiles, k_tiles, group)) == [
        (m, k) for m in range(m_tiles) for k in range(k_tiles)]


def test_k7_plan_at_the_train_shapes():
    """The block the plan picks at each recipe shape: 256 rows of gs by
    128 dx columns for the layer products at B=2, B=4 and B=16 and for the
    lm_head's loss chunk of B=4 (1,024 rows, one wave of 128 blocks) and
    B=16; the loss chunk of B=2 (512 rows: the int8-base pipeline bench's
    per-device batch, scripts/bench_train_pipeline.py, --loss_chunk 256)
    takes 128 rows, one wave of 128 blocks, not half a wave of 64 blocks
    of 256; so does a 256-row loss chunk (B=1), 64 blocks, not 32, on the
    132 SMs."""
    for M, K, N in ((8192, 4096, 4096), (8192, 4096, 11008),
                    (8192, 11008, 4096), (32768, 4096, 11008),
                    (32768, 11008, 4096), (4096, 4096, 4096),
                    (4096, 4096, 11008), (4096, 11008, 4096),
                    (1024, 4096, 32000), (4096, 4096, 32000)):
        rows, m_tiles, k_tiles, group = quant._k7_plan(M, K, N)
        assert (rows, m_tiles, k_tiles, group) == (
            256, -(-M // 256), -(-K // 128), min(8, -(-M // 256)))
    for M, blocks in ((512, 128), (256, 64)):
        rows, m_tiles, k_tiles, group = quant._k7_plan(M, 4096, 32000)
        assert (rows, m_tiles * k_tiles, group) == (128, blocks, M // 128)


@pytest.mark.parametrize("M,K,N", [(64, 4100, 4096), (64, 4096, 4104),
                                   (0, 4096, 4096), (64, 0, 4096)])
def test_k7_plan_refuses_misaligned(M, K, N):
    """K % 8 and N % 16 (TMA's 16-byte row strides), and empty shapes."""
    with pytest.raises(ValueError, match="K7"):
        quant._k7_plan(M, K, N)


@pytest.mark.parametrize("case", ["x_fp32", "g_fp64", "n_not_16",
                                  "k_not_8", "q_not_contiguous",
                                  "scale_bf16", "scale_count", "n_mismatch"])
def test_k7_checks_raise(case):
    """What K7 does not take raises before any launch; each pass alone
    (``_k7_scale``, ``_k7_product``) is held to the checks of the operands
    it reads (the first g, x's type and the scale; the second gs in x's
    type and q), and not to the other's."""
    rng = np.random.default_rng(2)
    K, N = 64, 48
    _, wq = _int8(rng, K, N)
    g = torch.zeros((16, N))
    q, scale, dtype = wq["q"], wq["scale"], torch.bfloat16
    quant._check_k7_inputs(g, q, scale, dtype)  # the unbroken inputs pass
    first = case in ("x_fp32", "g_fp64", "n_not_16", "scale_bf16",
                     "scale_count", "n_mismatch")
    second = case in ("x_fp32", "n_not_16", "k_not_8", "q_not_contiguous",
                      "n_mismatch")
    if case == "x_fp32":
        dtype = torch.float32
    elif case == "g_fp64":
        g = g.double()
    elif case == "n_not_16":
        g, q, scale = g[:, :40], q[:, :40].contiguous(), \
            scale[:, :40].contiguous()
    elif case == "k_not_8":
        q = q[:60].contiguous()
    elif case == "q_not_contiguous":
        q = torch.zeros((N, K), dtype=torch.int8).t()
    elif case == "scale_bf16":
        scale = scale.to(torch.bfloat16)
    elif case == "scale_count":
        scale = scale[:, :32].contiguous()
    elif case == "n_mismatch":
        g = torch.zeros((16, 32))
    with pytest.raises((TypeError, ValueError)):
        quant._check_k7_inputs(g, q, scale, dtype)
    for broken, args in ((first, (g, None, scale, dtype)),
                         (second, (g.to(dtype), q, None, dtype))):
        if broken:
            with pytest.raises((TypeError, ValueError)):
                quant._check_k7_inputs(*args)
        else:
            quant._check_k7_inputs(*args)


def test_every_kernel_has_its_profile_split():
    """Each ``__global__`` kernel of the port's CUDA sources lands in its
    own split of the smoke's profiles (``chip_smoke.PROFILE_SPLITS``), by
    its bare name and as the profiler prints it: a kernel that matches no
    split, or another kernel's, would drop out of its kernel's share."""
    import re
    import chip_smoke
    want = {"fa_fwd_kernel": "K1", "fd_split_kernel": "K2",
            "fa_bwd_dq_kernel": "K3", "fa_bwd_dkv_kernel": "K4",
            "fa_fwd_f32_kernel": "K1", "fa_bwd_dq_f32_kernel": "K3",
            "fa_bwd_dkv_f32_kernel": "K4",
            "dequant_gemv_stream_kernel": "K5", "dequant_gemv_kernel": "K5",
            "w8a16_gemm_kernel": "K6", "w8a16_dx_scale_kernel": "K7",
            "w8a16_dx_kernel": "K7", "add_rms_norm_kernel": "K8",
            "rope_kv_write_kernel": "K9", "silu_mul_kernel": "K10"}
    csrc = os.path.join(os.path.dirname(quant.__file__), os.pardir, "csrc")
    found = set()
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                found.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                    r"(\w+)\s*\(", f.read()))
    assert found == set(want)
    for kernel, split in want.items():
        assert chip_smoke._split_of(kernel) == split
        assert chip_smoke._split_of(
            f"void (anonymous namespace)::{kernel}<__nv_bfloat16, float>("
            f"...)") == split
