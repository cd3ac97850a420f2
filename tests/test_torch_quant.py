"""The port's int8 product (``ops/quant.dequant_matmul``, the wrapper of
kernel K5, and its plain version) against the JAX package's
``dequant_matmul`` on the CPU, where both the wrapper and the plain
version run the plain product (K5 has no CPU build; its card tests are in
tests/test_torch_kernels_cuda.py).

Inputs are seeded numpy arrays handed to both packages.  Tolerances,
relative to max |JAX|: 1e-5 for an fp32 result (int8 and bf16 values are
exact in fp32, so only the summation order differs) and 2e-2 for a bf16
result (one bf16 rounding of a sum taken in another order: ~0.4%).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.models.model import MultimodalLM as JaxLM
from modelcompose_tpu.ops import quant as jquant

from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.core import llama
from modelcompose_tpu_torch.ops import quant, routed_lora

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (K, N, out_dtype): narrow versions of the main path's shape classes
SHAPES = {
    "square": (128, 128, None),       # q/k/v/o
    "ragged_k": (344, 48, None),      # 2,752 / 8 rows: K % 64 != 0
    "lm_head": (64, 272, "float32"),  # fp32 logits; N % 128 != 0
}
ROWS = [1, 2, 3, 4, 8, 37]  # K5's decode rows, and a prefill-sized product


def _weight(rng, K, N):
    w = rng.normal(0, 0.02, (K, N)).astype(np.float32)
    wq = jquant.quantize_int8(jnp.asarray(w))
    return wq, {k: torch.from_numpy(np.array(v)) for k, v in wq.items()}


def _x(rng, M, K, dtype):
    x = rng.normal(size=(M, 1, K)).astype(np.float32)  # decode's [B, 1, K]
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _rel(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("fn", ["reference", "wrapper"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dequant_matmul_matches_jax(shape, M, dtype, fn):
    K, N, out = SHAPES[shape]
    rng = np.random.default_rng(K + N + M)
    jwq, twq = _weight(rng, K, N)
    tx, jx = _x(rng, M, K, dtype)
    t_out = out and getattr(torch, out)
    if fn == "reference":
        got = quant.dequant_matmul_reference(tx, twq, out_dtype=t_out)
    else:
        got = quant.dequant_matmul(tx, twq, out_dtype=t_out)
    want = jquant.dequant_matmul(jx, jwq, out_dtype=out and getattr(jnp, out))
    assert tuple(got.shape) == (M, 1, N)
    assert got.dtype == (t_out or tx.dtype)
    # an fp32 result of bf16 operands is exact products and fp32 sums
    assert _rel(got, want) <= TOL["float32" if out else dtype]


@pytest.mark.parametrize("out", [None, "float32"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_grad_matches_jax(dtype, out):
    """dL/dx of the wrapper (the plain product's autograd on the CPU) and
    of K5's backward (``_dequant_matmul_dx``) against ``jax.vjp``."""
    rng = np.random.default_rng(7)
    K, N, M = 96, 64, 3
    jwq, twq = _weight(rng, K, N)
    tx, jx = _x(rng, M, K, dtype)
    g = rng.normal(size=(M, 1, N)).astype(np.float32)
    t_out, j_out = (torch.float32, jnp.float32) if out else DTYPES[dtype]
    tg, jg = torch.from_numpy(g).to(t_out), jnp.asarray(g, j_out)
    _, vjp = jax.vjp(lambda x: jquant.dequant_matmul(x, jwq, out_dtype=j_out),
                     jx)
    want = vjp(jg)[0]
    tx.requires_grad_(True)
    y = quant.dequant_matmul(tx, twq, out_dtype=t_out)
    (got,) = torch.autograd.grad(y, tx, tg)
    assert got.dtype == tx.dtype
    assert _rel(got, want) <= TOL[dtype]
    dx = quant._dequant_matmul_dx(tg.reshape(M, N), twq["q"], twq["scale"],
                                  tx.dtype)
    assert dx.dtype == tx.dtype
    assert _rel(dx.reshape(M, 1, K), want) <= TOL[dtype]


def test_cpu_calls_launch_nothing():
    rng = np.random.default_rng(8)
    _, twq = _weight(rng, 64, 32)
    tx, _ = _x(rng, 2, 64, "bfloat16")
    before = quant.dequant_matmul.launches
    quant.dequant_matmul(tx, twq)
    quant.dequant_matmul(tx, twq, impl="reference")
    assert quant.dequant_matmul.launches == before


def test_unknown_impl_raises():
    rng = np.random.default_rng(9)
    _, twq = _weight(rng, 32, 16)
    tx, _ = _x(rng, 1, 32, "float32")
    with pytest.raises(ValueError, match="impl"):
        quant.dequant_matmul(tx, twq, impl="flash")


def _bad(case):
    """K5 inputs (x2, q, scale) broken one way."""
    rng = np.random.default_rng(10)
    x2 = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32)).to(
        torch.bfloat16)
    q = torch.from_numpy(rng.integers(-127, 128, (64, 48)).astype(np.int8))
    scale = torch.full((1, 48), 0.01)
    if case == "n_not_16":
        q, scale = q[:, :40].contiguous(), scale[:, :40].contiguous()
    elif case == "q_not_contiguous":
        q = torch.from_numpy(rng.integers(-127, 128, (48, 64)).astype(
            np.int8)).t()
    elif case == "x_fp32":
        x2 = x2.float()
    elif case == "x_strided":
        x2 = torch.zeros((2, 128), dtype=torch.bfloat16)[:, ::2]
    elif case == "k_mismatch":
        q = q[:32].contiguous()
    elif case == "scale_bf16":
        scale = scale.to(torch.bfloat16)
    elif case == "scale_short":
        scale = scale[:, :32].contiguous()
    return x2, q, scale


@pytest.mark.parametrize("case,error", [
    ("n_not_16", ValueError), ("q_not_contiguous", ValueError),
    ("x_fp32", TypeError), ("x_strided", ValueError),
    ("k_mismatch", ValueError), ("scale_bf16", ValueError),
    ("scale_short", ValueError)])
def test_k5_checks_raise(case, error):
    """The wrapper's argument checks, reached without a card."""
    quant._check_cuda_inputs(*_bad(None))  # the unbroken inputs pass
    with pytest.raises(error):
        quant._check_cuda_inputs(*_bad(case))


@pytest.mark.parametrize("M", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K,N", [
    (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
    (4096, 2048), (4096, 1024), (4096, 5504), (4096, 2752),
    (4096, 16000), (4096, 8000), (2048, 4096), (1024, 4096),
    (5504, 4096), (2752, 4096), (344, 48), (7, 16)])
def test_block_rows_split_k(monkeypatch, K, N, M):
    """K5's grid rule at every shape of the main path (Vicuna-7B, its tp 2
    and 4 shards) and two narrow ones: the splits cover K in whole steps;
    at 1-2 rows the streaming kernel's 512-column tiles (always at one
    row; at two where its estimated time is below the tensor-core
    kernel's), whole 64-row steps, one wave (at most two blocks an SM) and
    at most 32 KB of partials read by a tile's last block; at 2-8 rows the
    tensor-core kernel's 64-256-column tiles and 16-row steps up to 2048
    rows a block, at least 128 blocks (about one for each of the card's
    132 SMs) where K allows, the fp32 partials of 8 rows at most 1/8 of
    the weight's bytes and at most 32 KB read by a tile's last block; and
    the scratch ``_k5`` asks for is the rule's (the launch faked: no card
    here)."""
    tile, rows, splits, tiles = quant._k5_plan(M, K, N)
    if M == 1:
        assert tile == 512
    if M == 2:  # the kernel the cost picks
        assert (tile == 512) == (quant._two_row_us("stream", K, N)
                                 <= quant._two_row_us("mma", K, N))
        # measured: the streaming kernel is the faster at Vicuna-7B's
        # shapes, the tensor cores at the tp 2 / tp 4 q/k/v shards
        assert tile == TWO_ROWS.get((K, N), tile)
    if tile == 512:
        _stream_grid_holds(M, K, tiles, rows, splits)
    else:
        assert tile in (64, 128, 256) and rows % 16 == 0 and 0 < rows <= 2048
        if K >= 1024:
            assert tiles * splits >= 128
    assert tile % 16 == 0 and tiles == -(-N // tile)
    assert splits == -(-K // rows) and (splits - 1) * rows < K
    if M == 8 and splits > 1:
        assert splits * M * N * 4 <= K * N / 8
        assert splits * M * tile * 4 <= 32 * 1024

    asked, launched = _fake_launch(monkeypatch)
    x2 = torch.zeros((M, K), dtype=torch.bfloat16)
    q = torch.zeros((K, N), dtype=torch.int8)
    scale = torch.ones((1, N))
    quant._k5(x2, [{"q": q, "scale": scale}], torch.float32)
    args = launched[0]
    assert args[1] == 1 and list(args[5]) == [N]
    assert args[8:13] == (M, K, x2.stride(0) if M > 1 else K, rows, tile)
    part = tiles * splits * M * 512 if tile == 512 else splits * M * N
    assert asked == ([(part, tiles)] if splits > 1 else [])


TWO_ROWS = {(4096, 4096): 512, (4096, 11008): 512, (11008, 4096): 512,
            (4096, 32000): 512, (4096, 2048): 128, (4096, 1024): 64}


def _stream_grid_holds(M, K, tiles, rows, splits):
    """The streaming kernel's grid: whole 64-row steps, one wave (at most
    two blocks an SM), two only where a block streams 192 rows or more,
    and at most 32 splits for a tile's last block to add (64 KB a row of
    x); one split more would break one of those, where K allows it."""
    assert rows % 64 == 0 and rows > 0
    assert tiles * splits <= 2 * 132 or splits == 1
    assert tiles * splits <= 132 or rows >= 192
    assert splits <= 32  # a tile's last block reads 32 x 2 KB a row of x
    steps = -(-K // 64)
    more_rows = -(-steps // (splits + 1)) * 64
    more = -(-K // more_rows)
    if splits < min(32, steps) and tiles <= 132 and more > splits:
        assert tiles * more > 264 or tiles * more > 132 and more_rows < 192


def _fake_launch(monkeypatch):
    """K5's launches without a card: the library's entry records its
    arguments, and the scratch records what it was asked for."""
    asked, launched = [], []

    class Lib:
        def mc_w8a16_gemv(self, *args):
            launched.append(args)
            return 0

    get = quant._Scratch.get

    def spy(self, device, n_part, n_tiles):
        asked.append((n_part, n_tiles))
        return get(self, device, n_part, n_tiles)
    monkeypatch.setattr(quant._Scratch, "get", spy)
    monkeypatch.setattr(quant._build, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(quant, "_SCRATCH", {})
    return asked, launched


# The products that share an input, (K, [N, ...]): Vicuna-7B's q/k/v and
# gate/up and their tp 2 and tp 4 column shards, and two narrow ones.
GROUPS = {"qkv": (4096, [4096] * 3), "gate_up": (4096, [11008] * 2),
          "tp2 qkv": (4096, [2048] * 3), "tp2 gate_up": (4096, [5504] * 2),
          "tp4 qkv": (4096, [1024] * 3), "tp4 gate_up": (4096, [2752] * 2),
          "gqa": (128, [128, 32, 32]), "ragged": (344, [48, 272])}


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("group", list(GROUPS))
def test_group_plan_is_one_launch(monkeypatch, group, M):
    """A grouped launch's grid: one streaming launch over every member's
    512-column tiles, the splits covering K in whole 64-row steps, one
    wave, at most 32 KB of partials for a tile's last block, the scratch
    sized for the group (a counter for each of its tiles), and each
    member's weight, scale, output and columns passed in order."""
    K, Ns = GROUPS[group]
    tile, rows, splits, tiles = quant._k5_group_plan(M, K, Ns)
    assert tile == 512 and tiles == sum(-(-N // 512) for N in Ns)
    assert splits == -(-K // rows) and (splits - 1) * rows < K
    _stream_grid_holds(M, K, tiles, rows, splits)

    asked, launched = _fake_launch(monkeypatch)
    x2 = torch.zeros((M, K), dtype=torch.bfloat16)
    weights = [{"q": torch.zeros((K, N), dtype=torch.int8),
                "scale": torch.ones((1, N))} for N in Ns]
    outs = quant._k5(x2, weights, torch.float32)
    assert [tuple(o.shape) for o in outs] == [(M, N) for N in Ns]
    (args,) = launched
    n = len(Ns)
    assert args[1] == n and list(args[5]) == Ns
    assert list(args[2]) == [w["q"].data_ptr() for w in weights]
    assert list(args[3]) == [w["scale"].data_ptr() for w in weights]
    assert list(args[4]) == [o.data_ptr() for o in outs]
    assert args[8:13] == (M, K, x2.stride(0) if M > 1 else K, rows, 512)
    assert asked == ([(tiles * splits * M * 512, tiles)] if splits > 1
                     else [])


def test_scratch_grows_and_a_capture_keeps_what_it_outgrew():
    eager, record = quant._Scratch(), quant._Scratch(keep=True)
    for s in (eager, record):
        part, counters = s.get("cpu", 100, 3)
        assert part.numel() == 100 and counters.tolist() == [0, 0, 0]
        assert s.get("cpu", 50, 2)[0] is part  # a smaller launch reuses it
        bigger, _ = s.get("cpu", 200, 3)
        assert bigger.numel() == 200 and bigger is not part
    assert eager.outgrown is None
    assert len(record.outgrown) == 1 and record.outgrown[0].numel() == 100


def _int8_pair(seed=1):
    """The tiny vision model of test_torch_generate with an int8 base and
    lm_head, in both packages."""
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           local_prefix_tokens=2, local_suffix_tokens=2)
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for grp in ("attn", "mlp"):
        for p in jm.params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.05, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    jm.params = jquant.quantize_backbone(jm.params)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)
    numpy_model = types.SimpleNamespace(
        cfg=cfg, params=np_tree(jm.params), projectors=np_tree(jm.projectors),
        encoders={m: types.SimpleNamespace(spec=e.spec,
                                           params=np_tree(e.params))
                  for m, e in jm.encoders.items()})
    return jm, model_from_jax(numpy_model, device="cpu")


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_plain_choice_reaches_every_int8_product(monkeypatch, impl):
    """``attn_impl`` reaches the int8 products of every layer and the int8
    lm_head (through ``routed_lora_matmul`` and ``logits_from_hidden``),
    and either way the greedy ids equal the JAX package's."""
    jm, tm = _int8_pair()
    img = MODAL_TOKEN_INDEXES["vision"]
    ids = [np.array([1, 5, img, 9, 10, 11]), np.array([1, img, 7])]
    inputs = {"vision": np.random.default_rng(3).normal(
        0, 1, (2, 28, 28, 3)).astype(np.float32)}
    seen = []

    def spy(x, wq, out_dtype=None, impl="auto"):
        seen.append((impl, wq["q"].shape))
        return quant.dequant_matmul(x, wq, out_dtype, impl)
    monkeypatch.setattr(routed_lora, "dequant_matmul", spy)
    monkeypatch.setattr(llama, "dequant_matmul", spy)
    want = jm.generate(ids, inputs, max_new_tokens=8, bucket_len=32)
    got = tm.generate(ids, inputs, max_new_tokens=8, bucket_len=32,
                      attn_impl=impl)
    assert got == want
    V = tm.cfg.vocab_size
    assert {i for i, _ in seen} == {impl}
    assert any(shape[-1] == V for _, shape in seen)  # the lm_head
    assert sum(shape[-1] != V for _, shape in seen) >= 7 * 2  # every layer
