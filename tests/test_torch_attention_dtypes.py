"""Attention's dtypes on the CPU, with the card's launch rule emulated:
the kernels (K1-K4, K2) take bf16, fp16 and fp32 q, as the JAX kernels
feed their dots any of them; the CPU runs the plain versions at every
dtype.

The kernels have no CPU build (their card tests, fp16 and fp32 included,
are in tests/test_torch_kernels_cuda.py).  The emulation (``_Card``) runs
the real dispatch on CPU tensors: ``ops/_route.on_card`` says yes for
attention, no stream captures, and the launchers ``_k1_launch``,
``_k3_launch``, ``_k4_launch`` and ``flash_decode._k2`` run the wrappers'
own input checks and then the kernels' plain versions, each call counted
as the launch the card would make, with the dtype code its C entry would
be given.  So the routing (which dtype reaches a kernel wrapper), the
refusals and the results are checked without a card:

- bf16, fp16 and fp32 reach K1, K3 and K4 (K2 for a decode step) once a
  call; the real launchers hand their C entries the dtype codes 1, 0 and
  2 (a stand-in library records them);
- the results match the JAX ``flash_attention`` (its Pallas kernels in
  interpret mode, differentiated by ``jax.vjp``) and
  ``flash_decode_attention`` at fp32 (1e-5, the plain versions on the
  CPU) and fp16 (2e-2 of max |JAX|: an fp16 rounding of P and of the
  output);
- a q a kernel refuses for another reason (a head dim of 32, a GQA group
  of 3, fp64) raises; nothing catches it;
- a tiny fp16 model (head_dim 64) prefills and decodes through the
  kernels' route: its prefill logits within 2e-2 of the JAX package's and
  its greedy ids equal to them;
- ``--bf16 False`` gives an fp32 model config in both train entries alike.
"""

import argparse
import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.core import generate as jax_generate
from modelcompose_tpu.core import llama as jllama
from modelcompose_tpu.core.llama import quantize_kv as jax_quantize_kv
from modelcompose_tpu.models.model import MultimodalLM as JaxLM
from modelcompose_tpu.train import train_multimodal as jentry

from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.core import llama
from modelcompose_tpu_torch import _build
from modelcompose_tpu_torch.ops import (_route, attention, flash_attention,
                                        flash_decode)
from modelcompose_tpu_torch.train import train_multimodal as entry

jfa = importlib.import_module("modelcompose_tpu.ops.flash_attention")
jfd = importlib.import_module("modelcompose_tpu.ops.flash_decode")

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
LOGIT_TOL = 2e-2
IMG = MODAL_TOKEN_INDEXES["vision"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Card:
    """The card's launch rule on CPU tensors for attention: the wrappers
    see a card, and each launcher runs its wrapper's input checks and then
    its kernel's plain version, counted as one launch."""

    def __init__(self, monkeypatch):
        self.launches = []
        self.codes = []  # the dtype code of each launch
        fa = flash_attention
        monkeypatch.setattr(_route, "on_card",
                            lambda x, kernels: kernels == "attention")
        monkeypatch.setattr(fa, "_capture_record", lambda name: None)
        monkeypatch.setattr(fa, "_k1_launch", self.k1)
        monkeypatch.setattr(fa, "_k3_launch", self.k3)
        monkeypatch.setattr(fa, "_k4_launch", self.k4)
        monkeypatch.setattr(flash_decode, "_k2", self.k2)

    def _checked(self, name, q, k, v, q_seg, kv_seg):
        B, Lq = q.shape[:2]
        flash_attention._check_cuda_inputs(
            q, k, v, flash_attention._segments(q_seg, B, Lq, q.device),
            flash_attention._segments(kv_seg, B, k.shape[1], q.device))
        self.launches.append(name)
        self.codes.append(_route.dtype_code(q))

    def k1(self, q, k, v, causal, q_segment_ids, kv_segment_ids, q_offset,
           sm_scale, mask_all=False, record=None):
        self._checked("K1", q, k, v, q_segment_ids, kv_segment_ids)
        return flash_attention.flash_attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, q_offset=q_offset,
            sm_scale=sm_scale)

    def k3(self, q, k, v, do, lse, di, mask_all=False, record=None, **kw):
        self._checked("K3", q, k, v, kw["q_segment_ids"],
                      kw["kv_segment_ids"])
        return flash_attention.flash_attention_bwd_dq_reference(
            q, k, v, do, lse, di, **kw)

    def k4(self, q, k, v, do, lse, di, mask_all=False, record=None, **kw):
        self._checked("K4", q, k, v, kw["q_segment_ids"],
                      kw["kv_segment_ids"])
        return flash_attention.flash_attention_bwd_dkv_reference(
            q, k, v, do, lse, di, **kw)

    def k2(self, q, k_cache, v_cache, kv_len, layer_idx, sm_scale):
        k_q, k_s = flash_decode._parts(k_cache)
        v_q, v_s = flash_decode._parts(v_cache)
        flash_decode._check_cuda_inputs(q, k_q, v_q, k_s, v_s, kv_len)
        self.launches.append("K2")
        self.codes.append(_route.dtype_code(q))
        return flash_decode.flash_decode_reference(
            q, k_cache, v_cache, kv_len, layer_idx, sm_scale=sm_scale)

    def count(self, name):
        return self.launches.count(name)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what):
    got, want = _f32(got), _f32(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: {err:.3g} > {TOL[dtype]}"


# ------------------------------------------------------------- the prefill

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D,H,Hkv", [(64, 4, 2), (128, 2, 2)])
def test_attention_routes_by_dtype(monkeypatch, dtype, D, H, Hkv):
    """``attention(impl="auto")`` forward and backward with the card's rule
    emulated: bf16, fp16 and fp32 run K1, K3 and K4 once each, at their
    dtype code; out and the gradients of q, k and v against ``jax.vjp`` of
    the JAX ``flash_attention`` (interpret mode) on the same inputs,
    segment ids and a ragged row included, compared on the valid rows."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(D + H + len(dtype))
    B, L = 2, 80
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(B, L, H, D)).astype(np.float32)
    seg = (np.arange(L)[None] < np.array([[L], [53]])).astype(np.int32)
    valid = seg != 0
    do = do * valid[:, :, None, None]  # padding rows carry no cotangent

    def jfn(a, b, c):
        return jfa.flash_attention(a, b, c, causal=True,
                                   q_segment_ids=jnp.asarray(seg),
                                   kv_segment_ids=jnp.asarray(seg))
    want, vjp = jax.vjp(jfn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    kw = dict(causal=True, q_segment_ids=torch.from_numpy(seg),
              kv_segment_ids=torch.from_numpy(seg))

    def run():
        out = attention.attention(tq, tk, tv, **kw)
        return out, torch.autograd.grad(out, (tq, tk, tv),
                                        torch.from_numpy(do).to(tdt))
    with monkeypatch.context() as m:
        card = _Card(m)
        out, grads = run()
        assert [card.count(k) for k in ("K1", "K3", "K4")] == [1, 1, 1]
        assert card.codes == [_route.DTYPE_CODES[tdt]] * 3
    assert out.dtype == tdt and all(g.dtype == tdt for g in grads)
    _close(_f32(out)[valid], _f32(want)[valid], dtype, "out")
    for name, g, w in zip("qkv", grads, want_grads):
        _close(_f32(g)[valid], _f32(w)[valid], dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_autograd_function_launches_on_the_card(monkeypatch, dtype):
    """The autograd Function on the card: an fp32 or fp16 q goes through
    the kernel wrappers, K1 then K3 and K4, at its dtype code (fp32: 2,
    fp16: 0), bit-equal to K1's plain version forward and K3/K4's
    written-out backward (the emulated launchers run them); on the CPU
    the same plain versions, bit-equal too."""
    tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 40, 2, 64)).astype(
        np.float32)).to(tdt) for _ in range(4))
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))

    def run():
        out = flash_attention.flash_attention(tq, tk, tv, causal=True)
        return out, torch.autograd.grad(out, (tq, tk, tv), do)
    with monkeypatch.context() as m:
        card = _Card(m)
        on_card = run()
        assert card.launches == ["K1", "K3", "K4"]
        assert card.codes == [_route.DTYPE_CODES[tdt]] * 3
    want, lse = flash_attention.flash_attention_reference(q, k, v,
                                                          causal=True)
    wants = flash_attention.flash_attention_backward_reference(
        q, k, v, want, lse, do, causal=True)
    for out, grads in (on_card, run()):  # the card's route, then the CPU's
        assert torch.equal(out, want)
        for g, w in zip(grads, wants):
            assert torch.equal(g, w)


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_decode_attention_routes_by_dtype(monkeypatch, dtype, quantized):
    """``decode_attention(impl="auto")`` over a layer-stacked cache (the
    model's type, or int8 quantized once by the JAX package) with the
    card's rule emulated: bf16, fp16 and fp32 reach K2 once, at their dtype
    code; against the JAX ``flash_decode_attention`` (interpret mode) at
    the same dtype."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(13 + quantized)
    NL, B, S, H, Hkv, D = 3, 2, 384, 8, 2, 64
    k = rng.normal(size=(NL, B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(NL, B, S, Hkv, D)).astype(np.float32)
    if quantized:
        jk, jv = jax_quantize_kv(jnp.asarray(k)), jax_quantize_kv(
            jnp.asarray(v))
        tk, tv = ({n: torch.from_numpy(np.array(x)) for n, x in c.items()}
                  for c in (jk, jv))
    else:
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kv_len = np.array([384, 131], np.int32)
    want = jfd.flash_decode_attention(
        jnp.asarray(q, jdt), jk, jv, jnp.asarray(kv_len), jnp.int32(1),
        sm_scale=D ** -0.5)
    def run():
        return attention.decode_attention(
            torch.from_numpy(q).to(tdt), tk, tv, torch.from_numpy(kv_len),
            layer_idx=1)
    with monkeypatch.context() as m:
        card = _Card(m)
        got = run()
        assert card.launches == ["K2"]
        assert card.codes == [_route.DTYPE_CODES[tdt]]
    assert got.dtype == tdt and got.shape == (B, 1, H, D)
    _close(got, want, dtype, "decode")


# --------------------------------------------------------------- refusals

@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_a_refused_half_input_still_raises(monkeypatch, dtype):
    """A bf16 or fp16 q that a kernel refuses for another reason than its
    dtype raises on the card as an fp64 q does, with no fallback: a head
    dim of 32 at K1 (and so in the autograd Function), a GQA group of 3 at
    K2, a k of another type than q at K1."""
    tdt, _ = DTYPES[dtype]
    with monkeypatch.context() as m:
        _Card(m)
        q = torch.zeros((1, 16, 2, 32), dtype=tdt)
        with pytest.raises(ValueError, match="head_dim"):
            attention.attention(q, q, q)
        q = torch.zeros((1, 16, 2, 64), dtype=tdt)
        with pytest.raises(TypeError):
            attention.attention(q, q.float(), q.float())
        cache = torch.zeros((1, 1, 8, 1, 64), dtype=tdt)
        with pytest.raises(ValueError, match="GQA"):
            attention.decode_attention(torch.zeros((1, 1, 3, 64), dtype=tdt),
                                       cache, cache, 4, layer_idx=0)
        with pytest.raises(TypeError):  # a cache of the other half type
            other = torch.float16 if tdt == torch.bfloat16 \
                else torch.bfloat16
            attention.decode_attention(torch.zeros((1, 1, 2, 64), dtype=tdt),
                                       cache.to(other), cache.to(other), 4,
                                       layer_idx=0)
        with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
            attention.attention(q.double(), q.double(), q.double())
        with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
            attention.decode_attention(torch.zeros((1, 1, 2, 64)).double(),
                                       cache.double(), cache.double(), 4,
                                       layer_idx=0)
    assert _route.kernel_dtype(q) and not _route.kernel_dtype(q.float())


# ------------------------------------------------------ a tiny fp16 model

def _numpy_model(jm):
    def np_tree(t):
        return jax.tree.map(np.asarray, t)
    encoders = {m: types.SimpleNamespace(spec=e.spec, params=np_tree(e.params))
                for m, e in jm.encoders.items()}
    return types.SimpleNamespace(cfg=jm.cfg, params=np_tree(jm.params),
                                 projectors=np_tree(jm.projectors),
                                 encoders=encoders)


def test_tiny_fp16_model_matches_jax(monkeypatch):
    """A 2-layer fp16 model of hidden 256 (head_dim 64, the kernels' width)
    with a tiny CLIP tower and nonzero LoRA B, the card's rule emulated:
    its prefill runs K1 once a layer and its decode K2 once a layer a step;
    the prefill logits within 2e-2 of the JAX package's ``forward`` on the
    same embeddings and the greedy ids of 8 steps equal to the JAX
    ``generate``'s."""
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu", dtype="float16",
                           hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=4)
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    for grp in ("attn", "mlp"):
        for p in jm.params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.05, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    tm = model_from_jax(_numpy_model(jm), device="cpu")
    pixels = rng.normal(0, 1, (2, 28, 28, 3)).astype(np.float32)
    ids = [np.array([1, 5, IMG, 9, 10, 11]), np.array([1, IMG, 7])]
    inputs = {"vision": pixels}
    steps = 8
    embeds, plan = jm.prepare_batch(ids, inputs, bucket_len=32)
    kw = dict(route_ids=jnp.asarray(plan.route_ids),
              routing_table=jm.routing_table,
              segment_ids=jnp.asarray(plan.segment_ids))
    want_logits, _ = jllama.forward(jm.params, cfg, embeds, **kw)
    want_ids = jax_generate.generate(
        jm.params, cfg, embeds, lengths=plan.lengths,
        route_ids=plan.route_ids, routing_table=jm.routing_table,
        segment_ids=plan.segment_ids, max_new_tokens=steps)
    n = cfg.num_hidden_layers
    with monkeypatch.context() as m:
        card = _Card(m)
        t_emb, t_plan = tm.prepare_batch(ids, inputs, bucket_len=32)
        assert t_emb.dtype == torch.float16
        with torch.no_grad():
            logits, _ = llama.forward(
                tm.params, tm.cfg, t_emb,
                route_ids=torch.as_tensor(t_plan.route_ids),
                routing_table=tm.routing_table,
                segment_ids=torch.as_tensor(t_plan.segment_ids))
        assert card.count("K1") == n and card.count("K2") == 0
        del card.launches[:]
        got_ids = tm.generate(ids, inputs, max_new_tokens=steps,
                              bucket_len=32)
        assert card.count("K1") == n
        assert card.count("K2") == n * (max(len(r) for r in got_ids) - 1)
    valid = np.asarray(plan.segment_ids) != 0
    want = np.asarray(jnp.asarray(want_logits, jnp.float32))
    assert np.isfinite(logits.numpy()).all()
    err = np.abs(logits.numpy()[valid] - want[valid]).max() \
        / np.abs(want[valid]).max()
    assert err <= LOGIT_TOL, err
    assert got_ids == want_ids


# ------------------------------------------ the dtype codes of the C entries

class _Lib:
    """A stand-in for the built kernel libraries: each C entry records the
    dtype code it is handed (the argument after ``causal, q_offset`` for
    K1, K3 and K4; after ``layer, quantized`` for K2) and returns 0."""

    def __init__(self):
        self.codes = {}

    def _entry(self, name, index):
        def call(*args):
            self.codes.setdefault(name, []).append(args[index])
            return 0
        return call

    def __getattr__(self, fn):
        if fn == "mc_flash_decode_split_len":
            return lambda: 128
        # q k v q_seg kv_seg out lse B H Hkv Lq S D sm_scale causal
        # q_offset dtype stream; K3 adds dout and dq, K4 dout, dk and dv;
        # K2: q kc vc ks vs kv_len m l acc counters out NL B H Hkv S D
        # layer quantized dtype sm_scale stream
        index = {"mc_flash_attention_fwd": 16,
                 "mc_flash_attention_bwd_dq": 18,
                 "mc_flash_attention_bwd_dkv": 19,
                 "mc_flash_decode": 19}[fn]
        return self._entry(fn, index)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_launchers_hand_the_dtype_code(monkeypatch, dtype):
    """The real launchers of K1, K3, K4 and K2 on CPU tensors, with a
    stand-in library (no card: nothing runs): each hands its C entry the
    code of q's type, fp16 0, bf16 1, fp32 2, as csrc/hopper.cuh's
    ``DType`` reads it; K2 over a cache of q's type and over int8."""
    tdt, _ = DTYPES[dtype]
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(flash_decode, "_SCRATCH", {})
    q = torch.zeros((1, 16, 2, 64), dtype=tdt)
    lse = torch.zeros((1, 2, 16))
    kw = dict(causal=True, q_segment_ids=None, kv_segment_ids=None,
              q_offset=0, sm_scale=None)
    fa = flash_attention
    fa._k1_launch(q, q, q, True, None, None, 0, None)
    fa._k3_launch(q, q, q, q, lse, lse, **kw)
    fa._k4_launch(q, q, q, q, lse, lse, **kw)
    cache = torch.zeros((2, 1, 32, 2, 64), dtype=tdt)
    lens = torch.tensor([5], dtype=torch.int32)
    flash_decode._k2(q[:, :1].contiguous(), cache, cache, lens, 1, 0.125)
    int8 = {"q": torch.zeros((2, 1, 32, 2, 64), dtype=torch.int8),
            "scale": torch.ones((2, 1, 32, 2, 1))}
    flash_decode._k2(q[:, :1].contiguous(), int8, int8, lens, 1, 0.125)
    code = {"float16": 0, "bfloat16": 1, "float32": 2}[dtype]
    assert _route.dtype_code(q) == code
    assert lib.codes == {"mc_flash_attention_fwd": [code],
                         "mc_flash_attention_bwd_dq": [code],
                         "mc_flash_attention_bwd_dkv": [code],
                         "mc_flash_decode": [code, code]}


# ------------------------------------------------ the train entry's --bf16

def test_bf16_false_builds_an_fp32_config_in_both_entries(tmp_path):
    """``--bf16 False`` on the train entry's flags (the stage-2 point
    recipe's, over a base directory with a Llama config.json) gives a
    float32 ModelConfig in the port as in the JAX package, equal field by
    field; ``--bf16 True`` (the default) bfloat16 in both."""
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(vocab_size=1024, hidden_size=256,
                       intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2,
                       max_position_embeddings=512), f)
    flags = ["--model_name_or_path", str(tmp_path), "--data_path", "x.json",
             "--output_dir", str(tmp_path / "out"), "--version", "v1",
             "--lora_strategy", "modal+language", "--lora_r", "8",
             "--lora_alpha", "16", "--mm_point_encoder", "test:32x2",
             "--mm_point_projector_type", "mlp2x_gelu",
             "--gradient_checkpointing", "True"]
    for bf16, want in (("False", "float32"), ("True", "bfloat16"),
                       (None, "bfloat16")):
        extra = [] if bf16 is None else ["--bf16", bf16]
        args = entry.build_arg_parser().parse_args(flags + extra)
        jargs = jentry.build_arg_parser().parse_args(flags + extra)
        assert isinstance(args, argparse.Namespace)
        cfg, jcfg = (entry.build_model_config(args),
                     jentry.build_model_config(jargs))
        assert cfg.dtype == jcfg.dtype == want
        assert cfg.to_dict() == jcfg.to_dict()
        assert cfg.num_hidden_layers == 2 and cfg.remat
