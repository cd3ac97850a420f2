"""The port's Llama backbone against the JAX package on the same weights.

Weights are made by the JAX package's ``init_params`` (with nonzero LoRA B,
so routing matters) and cross by ``convert.params_from_jax``.  Tolerances:
the fp32 config differs in summation order only, which grows to ~1e-5
relative through the layers (held to 1e-4 of max |logit|); bf16 is held to
2e-2 of max |logit|.  Logits are compared on valid (non-padding) rows.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.core import llama as jllama
from modelcompose_tpu.ops.quant import quantize_backbone as jax_quantize

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.core import llama
from modelcompose_tpu_torch.core.generate import _decode_step, _prefill

jgen = importlib.import_module("modelcompose_tpu.core.generate")

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _port(cfg):
    """The port's config from the JAX config's dict: each package gets
    its own config class."""
    return PortConfig.from_dict(cfg.to_dict())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed, quantized):
    params = jllama.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.05, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    return jax_quantize(params) if quantized else params


def _to_torch(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _inputs(cfg, seed, B=2, L=12, classes=(0, 2)):
    rng = np.random.default_rng(seed + 100)
    embeds = rng.normal(0, 1, (B, L, cfg.hidden_size)).astype(np.float32)
    route_ids = rng.choice(classes, size=(B, L)).astype(np.int32)
    lengths = np.array([L, L - 5][:B], np.int32)
    seg = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    return embeds, route_ids, seg, lengths


def _t(a, like=None):
    t = torch.from_numpy(np.array(a))
    return t.to(like) if like is not None else t


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _assert_logits(got, want, dtype, valid=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if valid is not None:
        got, want = got[valid], want[valid]
    tol = TOL[dtype] * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("routed", [True, False])
def test_forward_logits_match_jax(dtype, quantized, routed):
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16,
                           dtype=dtype)
    jp = _jax_params(cfg, 0, quantized)
    tp = _to_torch(jp)
    embeds, route_ids, seg, _ = _inputs(cfg, 0)
    table = cfg.routing_table() if routed else None
    t_dt = llama.torch_dtype(dtype)
    got, cache = llama.forward(tp, _port(cfg), _t(embeds, t_dt),
                               route_ids=_t(route_ids), routing_table=table,
                               segment_ids=_t(seg))
    want, _ = jllama.forward(jp, cfg, _j(embeds, jnp.dtype(dtype)),
                             route_ids=_j(route_ids), routing_table=table,
                             segment_ids=_j(seg))
    assert cache is None and got.dtype == torch.float32
    _assert_logits(got, want, dtype, seg != 0)


def test_composed_online_merge_table_matches_jax():
    """A tiny four-modality online-merge-reset composition (the shape of
    the MCUB-4 config): 9 stacked adapters, every route class present, fed
    embeddings and route ids directly (no towers)."""
    cfg = tiny_test_config(
        mm_vision_encoder="x", mm_hidden_size=16, mm_audio_encoder="x",
        mm_audio_hidden_size=16, mm_video_encoder="x",
        mm_video_hidden_size=16, mm_point_encoder="x",
        mm_point_hidden_size=16,
        reset_scaling_weights=("default-vision=0.25,default-audio=0.25,"
                               "default-video=0.25,default-point=0.25"))
    assert len(cfg.adapter_names()) == 9
    jp = _jax_params(cfg, 1, False)
    tp = _to_torch(jp)
    embeds, route_ids, seg, _ = _inputs(cfg, 1, L=16, classes=(0, 1, 2, 3, 4))
    table = cfg.routing_table()
    got, _ = llama.forward(tp, _port(cfg), _t(embeds), route_ids=_t(route_ids),
                           routing_table=table, segment_ids=_t(seg))
    want, _ = jllama.forward(jp, cfg, _j(embeds), route_ids=_j(route_ids),
                             routing_table=table, segment_ids=_j(seg))
    _assert_logits(got, want, "float32", seg != 0)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_then_decode_matches_one_shot_and_jax(kv_quant):
    """Prefill into the cache, then one decode step of the next token: its
    logits equal the one-shot forward's last position over the whole
    sequence (bf16 cache: fp32 exactness; int8 cache: its quantization
    error), and equal the JAX package's prefill + decode step."""
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16)
    jp = _jax_params(cfg, 2, False)
    tp = _to_torch(jp)
    embeds, route_ids, seg, lengths = _inputs(cfg, 2, B=2, L=10)
    table = cfg.routing_table()
    next_tok = np.array([7, 11], np.int32)
    cache_len = 16

    logits0, cache = _prefill(tp, _port(cfg), _t(embeds), _t(route_ids),
                              _t(table), _t(seg), _t(lengths), cache_len,
                              kv_quant=kv_quant)
    assert isinstance(cache.k, dict) == kv_quant
    logits1, cache, kv_lens = _decode_step(tp, _port(cfg), cache, _t(next_tok),
                                           _t(lengths), _t(table))
    assert kv_lens.tolist() == (lengths + 1).tolist()

    j0, jcache = jgen._prefill(jp, cfg, _j(embeds), _j(route_ids),
                               _j(table), _j(seg), _j(lengths), cache_len,
                               "auto", kv_quant)
    j1, _, _ = jgen._decode_step(jp, cfg, jcache, _j(next_tok),
                                 _j(lengths), _j(table))
    _assert_logits(logits0, j0, "float32")
    _assert_logits(logits1, j1, "float32")

    # One shot: the prompt with the new token spliced in after each row's
    # last valid position (route class 0, as decode routes it).
    tok_emb = np.asarray(jp["embed_tokens"])[next_tok]
    full = np.zeros((2, 11, cfg.hidden_size), np.float32)
    routes = np.zeros((2, 11), np.int32)
    for b, n in enumerate(lengths):
        full[b, :n], routes[b, :n] = embeds[b, :n], route_ids[b, :n]
        full[b, n] = tok_emb[b]
    seg1 = (np.arange(11)[None] < (lengths + 1)[:, None]).astype(np.int32)
    one_shot, _ = llama.forward(tp, _port(cfg), _t(full), route_ids=_t(routes),
                                routing_table=table, segment_ids=_t(seg1))
    last = one_shot[torch.arange(2), torch.from_numpy(lengths).long()]
    tol = 1e-4 if not kv_quant else 3e-2  # int8 k/v: ~1/254 per vector
    assert float((logits1 - last).abs().max()) <= tol * float(
        last.abs().max())


def test_kv_cache_and_quantize_kv_match_jax():
    cfg = tiny_test_config()
    for quantized in (False, True):
        got = llama.KVCache.zeros(_port(cfg), 3, 20, quantized=quantized)
        want = jllama.KVCache.zeros(cfg, 3, 20, quantized=quantized)
        for g, w in ((got.k, want.k), (got.v, want.v)):
            g_leaves = g.values() if quantized else [g]
            w_leaves = w.values() if quantized else [w]
            for gl, wl in zip(g_leaves, w_leaves):
                assert tuple(gl.shape) == wl.shape
                assert str(gl.dtype).split(".")[-1] == str(wl.dtype)
    val = np.random.default_rng(3).normal(size=(2, 5, 4, 16)).astype(
        np.float32)
    got = llama.quantize_kv(torch.from_numpy(val))
    want = jllama.quantize_kv(jnp.asarray(val))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    cfg = tiny_test_config(mm_vision_encoder="x", mm_hidden_size=16,
                           local_prefix_tokens=3, local_suffix_tokens=2,
                           dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    got = llama.init_params(_port(cfg), gen, "cpu")
    want = jllama.init_params(cfg, jax.random.PRNGKey(0))
    g_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                     got, is_leaf=lambda x: isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, tuple))
    w_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), want),
        is_leaf=lambda x: isinstance(x, tuple))
    assert g_leaves == w_leaves
    # LoRA A ~ U(+-1/sqrt(d_in)) as peft, B = 0
    a = got["layers"]["mlp"]["down"]["lora_a"].float()
    assert float(a.abs().max()) <= cfg.intermediate_size ** -0.5
    assert not got["layers"]["attn"]["q"]["lora_b"].any()


def test_chunked_prefill_is_not_ported_yet():
    cfg = _port(tiny_test_config())
    tp = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = llama.KVCache.zeros(cfg, 1, 8)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        llama.forward_hidden(tp, cfg, torch.zeros(1, 4, cfg.hidden_size),
                             cache=cache,
                             cache_write_pos=torch.zeros(1, dtype=torch.int32))
