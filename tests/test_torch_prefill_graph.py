"""The compiled encode and prefill: ``core/prefill_graph`` (``PrefillGraph``,
the chunk-step graphs of a ``ChunkedAdmission``, ``PrefillGraphs``) and
``models/towers.TowerGraphs``, against the port's eager functions and the
JAX package's jitted ``_prefill``, ``prefill_chunked`` and towers'
``_encode``.

On the CPU every graph runs its step eagerly into the same static buffers
and caches the card's graph reads by address, so these tests hold the
buffer logic: equal to the port's eager path exactly (the same arithmetic
on copies of the same inputs), and to the JAX package within 1e-5 of the
largest magnitude where everything is fp32 and 2e-2 where the model runs
in bf16 or the cache is int8 (one rounding step of 127 levels is 0.8%).
The JAX side runs as its own tests run it on the CPU (the Pallas kernels
in interpret mode).  The graphs themselves (capture, replay, K1 inside,
logits bit-equal to eager) are held on the card by
tests/test_torch_kernels_cuda.py.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from modelcompose_tpu.config import ROUTE_CLASS_INDEX
from modelcompose_tpu.config import tiny_test_config as jax_tiny_config
from modelcompose_tpu.core import generate as jgen
from modelcompose_tpu.core.llama import init_params as jax_init_params
from modelcompose_tpu.models import text_clip as jtext
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

from modelcompose_tpu_torch.config import ModelConfig
from modelcompose_tpu_torch.convert import model_from_jax, params_from_jax
from modelcompose_tpu_torch.core import generate as tgen
from modelcompose_tpu_torch.core import prefill_graph as pg
from modelcompose_tpu_torch.core.decode_graph import DecodeGraph
from modelcompose_tpu_torch.models import text_clip as ttext
from modelcompose_tpu_torch.models.towers import TowerGraph, TowerGraphs
from modelcompose_tpu_torch.parallel import tp
from tests.test_torch_generate import _batch, _numpy_model, _pair
from tests.test_torch_text_clip import CFG as TEXT_CFG
from tests.test_torch_text_clip import _ids, _jcfg, _randomized
from tests.test_torch_towers import (BF16_TOL, FP32_TOL, _assert_close,
                                     _randomize)

L, S = 16, 32  # the prompt bucket and the cache length
LENGTHS = np.array([13, 9], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _backbone(dtype):
    """A tiny backbone with nonzero LoRA B in both packages, and two
    right-padded prompts of 13 and 9 positions in 16 (a vision span in
    the first), as numpy: (jax cfg, jax params, port cfg, port params,
    embeds, route ids, segment ids)."""
    cfg = jax_tiny_config(mm_vision_encoder="x", mm_hidden_size=8,
                          dtype=dtype)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(rng.normal(0, 0.1, p["lora_b"].shape),
                                      p["lora_b"].dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    embeds = (np.random.default_rng(2).normal(size=(2, L, cfg.hidden_size))
              * 0.1).astype(np.float32)
    route = np.zeros((2, L), np.int32)
    route[0, 2:5] = ROUTE_CLASS_INDEX["vision"]
    seg = (np.arange(L)[None] < LENGTHS[:, None]).astype(np.int32)
    return (cfg, params, ModelConfig.from_dict(cfg.to_dict()), tparams,
            embeds, route, seg)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def backbone(request):
    return _backbone(request.param)


def _tol(cfg, kv_quant=False):
    return FP32_TOL if cfg.dtype == "float32" and not kv_quant else BF16_TOL


def _torch_embeds(embeds, tcfg):
    t = torch.from_numpy(embeds)
    return t.to(torch.bfloat16) if tcfg.dtype == "bfloat16" else t


def _jax_embeds(embeds, cfg):
    return jnp.asarray(embeds, jnp.bfloat16 if cfg.dtype == "bfloat16"
                       else jnp.float32)


def _port_args(tcfg, embeds, route, seg, lengths=LENGTHS):
    return (_torch_embeds(embeds, tcfg), torch.from_numpy(route),
            torch.as_tensor(tcfg.routing_table()), torch.from_numpy(seg),
            torch.from_numpy(lengths))


def _dequant(part):
    """A cache part as fp32 numpy: int8 values times their scales."""
    if isinstance(part, dict):
        return (np.asarray(part["q"], np.float32)
                * np.asarray(part["scale"], np.float32))
    return np.asarray(part.float() if isinstance(part, torch.Tensor)
                      else part, np.float32)


def _np(cache):
    return {p: _dequant({k: v.numpy() for k, v in getattr(cache, p).items()}
                        if isinstance(getattr(cache, p), dict)
                        else getattr(cache, p))
            for p in ("k", "v")}


def _assert_caches_equal(got, want):
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a, b)


# ------------------------------------------------------- one-shot prefill

@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_graph_equals_prefill_and_jax(backbone, kv_quant):
    """Two calls through a model's ``PrefillGraphs`` (the card's eager and
    capturing calls; both eager here) equal ``_prefill`` into a fresh
    cache exactly, and the JAX ``_prefill`` within the stated tolerance,
    logits and cache (its valid rows: padding rows are garbage in both)."""
    cfg, params, tcfg, tparams, embeds, route, seg = backbone
    want_logits, want_cache = jgen._prefill(
        params, cfg, _jax_embeds(embeds, cfg), jnp.asarray(route),
        jnp.asarray(cfg.routing_table()), jnp.asarray(seg),
        jnp.asarray(LENGTHS), S, "auto", kv_quant)
    args = _port_args(tcfg, embeds, route, seg)
    graphs = pg.PrefillGraphs()
    with torch.no_grad():
        eager_logits, eager_cache = tgen._prefill(
            tparams, tcfg, *args, S, kv_quant=kv_quant)
        for _ in range(2):
            logits, cache = pg.prefill(tparams, tcfg, *args, S,
                                       kv_quant=kv_quant, graphs=graphs)
            assert torch.equal(logits, eager_logits)
            _assert_caches_equal(cache, eager_cache)
    (graph,) = graphs.one_shot.values()
    assert graph.calls == 2 and logits is graph.logits
    assert cache is graph.cache
    tol = _tol(cfg, kv_quant)
    _assert_close(logits, np.asarray(want_logits, np.float32), _tol(cfg))
    got, want = _np(cache), {p: _dequant(
        jax.tree.map(np.asarray, getattr(want_cache, p)))
        for p in ("k", "v")}
    for b, n in enumerate(LENGTHS):
        for p in ("k", "v"):
            _assert_close(torch.from_numpy(got[p][:, b, :n]),
                          want[p][:, b, :n], tol)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_a_reused_cache_equals_a_fresh_one(backbone, kv_quant):
    """A decode graph's cache holding a decoded request (every position
    written) and the shared cache of the prefill graphs written by a
    prompt batch of a longer bucket, each then prefilled: equal to a fresh
    cache, their tails zeroed."""
    _, _, tcfg, tparams, embeds, route, seg = backbone
    wide = np.concatenate([embeds, embeds], 1)  # a 32-position bucket
    args = _port_args(tcfg, embeds, route, seg)
    graphs = pg.PrefillGraphs()
    decode = DecodeGraph(tparams, tcfg, 2, S + 8, kv_quant=kv_quant)
    for t in decode.cache.tensors():
        t.fill_(3)
    with torch.no_grad():
        want, fresh = tgen._prefill(tparams, tcfg, *args, S + 8,
                                    kv_quant=kv_quant)
        pg.prefill(tparams, tcfg, *_port_args(
            tcfg, wide, np.zeros((2, 2 * L), np.int32),
            np.ones((2, 2 * L), np.int32), np.full(2, 2 * L, np.int32)),
            S + 8, kv_quant=kv_quant, graphs=graphs)
        shared = next(iter(graphs.one_shot.values())).cache
        assert any(t[:, :, L:].any() for t in shared.tensors())
        for kw in (dict(decode_graph=decode), {}):
            logits, cache = pg.prefill(tparams, tcfg, *args, S + 8,
                                       kv_quant=kv_quant, graphs=graphs, **kw)
            assert torch.equal(logits, want)
            _assert_caches_equal(cache, fresh)
    assert cache is shared and len(graphs.one_shot) == 2
    assert len(decode.prefills) == 1


# ------------------------------------------------------- chunked admission

@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunk_steps_equal_prefill_chunked_and_jax(backbone, kv_quant):
    """The chunk-step graphs of one admission (pieces of 5: three of 5 and
    a tail of 1) equal ``prefill_chunked``'s eager path exactly, twice
    over the one persistent cache (a longer prompt between, whose rows past
    this one's bucket are zeroed again), and the JAX ``prefill_chunked``
    within the stated tolerance."""
    cfg, params, tcfg, tparams, embeds, route, _ = backbone
    one = embeds[:1]
    want_logits, want_cache = jgen.prefill_chunked(
        params, cfg, _jax_embeds(one, cfg), route[:1], cfg.routing_table(),
        LENGTHS[:1], S, chunk=5, kv_quant=kv_quant)
    graphs = pg.PrefillGraphs()
    table = tcfg.routing_table()
    ticks = []
    kw = dict(chunk=5, kv_quant=kv_quant, tick_cb=lambda: ticks.append(1))
    with torch.no_grad():
        eager_logits, eager_cache = tgen.prefill_chunked(
            tparams, tcfg, _torch_embeds(one, tcfg), route[:1], table,
            LENGTHS[:1], S, **kw)
        runs = []
        for prompt in (one, np.concatenate([one, one], 1), one):
            n = min(prompt.shape[1], int(LENGTHS[0]))
            runs.append(tgen.prefill_chunked(
                tparams, tcfg, _torch_embeds(prompt, tcfg),
                np.tile(route[:1], (1, prompt.shape[1] // L)), table,
                np.array([n], np.int32), S, graphs=graphs, **kw))
    assert len(ticks) == 4 + 4 + 7 + 4  # one tick a piece
    for logits, cache in (runs[0], runs[2]):
        assert torch.equal(logits, eager_logits)
        _assert_caches_equal(cache, eager_cache)
    (admission,) = graphs.admissions.values()
    assert runs[0][1] is admission.cache is runs[2][1]
    assert sorted(admission.steps) == [(0, 5), (5, 5), (10, 5), (15, 1),
                                       (15, 5), (20, 5), (25, 5), (30, 2)]
    assert admission.steps[(0, 5)].calls == 3
    logits, cache = runs[2]
    _assert_close(logits, np.asarray(want_logits, np.float32),
                  _tol(cfg, kv_quant))
    n = int(LENGTHS[0])
    got = _np(cache)
    for p in ("k", "v"):
        want = _dequant(jax.tree.map(np.asarray, getattr(want_cache, p)))
        _assert_close(torch.from_numpy(got[p][:, :, :n]), want[:, :, :n],
                      _tol(cfg, kv_quant))


# ------------------------------------------------------- graph bookkeeping

@pytest.fixture(scope="module")
def vision():
    return _pair(1)


def test_model_graphs_are_reused_by_shape_and_dropped_with_their_owner(
        vision):
    """generate's prefill graph lives in the decode graph that decodes the
    request (one per bucket, reused by the next request of the shape, gone
    when the decode LRU drops that graph); one new token has no decode
    graph, so its prefill graph is the model's own, on a shared cache;
    new params drop every graph."""
    _, tm = vision
    tm.decode_graphs.clear()
    tm.prefill_graphs.clear()
    ids, inputs = _batch()
    first = tm.generate(ids, inputs, max_new_tokens=4, bucket_len=32)
    (decode,) = tm.decode_graphs.values()
    (prefill,) = decode.prefills.values()
    assert tm.generate(ids, inputs, max_new_tokens=4, bucket_len=32) == first
    assert tm.decode_graphs.values() == [decode]
    assert decode.prefills.values() == [prefill] and prefill.calls == 2
    assert prefill.cache is decode.cache and len(tm.prefill_graphs) == 0
    one = tm.generate(ids, inputs, max_new_tokens=1, bucket_len=32)
    assert [r[:1] for r in first] == one
    (own,) = tm.prefill_graphs.one_shot.values()
    assert own.cache is not decode.cache
    for n in (6, 8):  # two more decode shapes: the first graph goes
        tm.generate(ids, inputs, max_new_tokens=n, bucket_len=32)
    assert decode not in tm.decode_graphs.values()
    tm.params = tm.params
    assert len(tm.decode_graphs) == 0 and len(tm.prefill_graphs) == 0


def test_prefill_graphs_evict_the_oldest_and_its_cache():
    """At most ``limit`` one-shot graphs; a shared cache goes with the last
    graph that writes it."""
    _, _, tcfg, tparams, embeds, route, seg = _backbone("float32")
    graphs = pg.PrefillGraphs(limit=2)
    with torch.no_grad():
        for cache_len in (S, S + 4, S + 8):
            pg.prefill(tparams, tcfg, *_port_args(tcfg, embeds, route, seg),
                       cache_len, graphs=graphs)
    assert len(graphs.one_shot) == 2
    assert sorted(g.cache_len for g in graphs.one_shot.values()) \
        == [S + 4, S + 8]
    assert len(graphs._caches) == 2


def test_capture_comes_at_the_second_call(monkeypatch):
    """The call counting of ``CapturedStep.run`` as the card runs it (a
    stand-in capture and replay): a prefill graph's first call is eager,
    its second captures, its third replays; a decode graph captures at its
    first."""
    _, _, tcfg, tparams, embeds, route, seg = _backbone("float32")
    events = []

    def capture(self):
        events.append("capture")
        self.graph = "captured"

    def replay(self):
        events.append("replay")
    monkeypatch.setattr(pg.PrefillGraph, "_capture", capture)
    monkeypatch.setattr(pg.PrefillGraph, "replay", replay)
    graphs = pg.PrefillGraphs()
    args = _port_args(tcfg, embeds, route, seg)
    with torch.no_grad():
        graph = graphs.get(tparams, tcfg, args[0], args[1], args[2], S)
        graph.device = torch.device("cuda")  # counted as on the card
        compute = graph._compute
        monkeypatch.setattr(graph, "_compute", lambda: (
            events.append("eager"), compute())[1])
        for _ in range(3):
            graph(args[0], args[1], args[3], args[4])
    assert events == ["eager", "capture", "replay"]
    assert graph.calls == 3
    assert pg.PrefillGraph.capture_at == 2 == TowerGraph.capture_at
    assert DecodeGraph.capture_at == 1


@pytest.fixture
def gloo_group(tmp_path):
    """A gloo model group of one process."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/rendezvous",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    group = dist.new_group([0])
    yield group
    if made:
        dist.destroy_process_group()


def test_graphs_refuse_a_model_group_and_the_prefill_runs_eagerly(
        gloo_group):
    """Prefill graphs belong to the model group they were made under:
    under a gloo group of one, ``prefill`` and ``prefill_chunked`` given
    graphs run through graphs of that group (a one-shot graph on a shared
    cache of the group, a chunked admission with its own persistent cache)
    equal to the eager path; the same calls with no group make graphs and
    caches of their own, as another group of the same ranks does; a graph
    made under no group refuses a call under the group.  With grad on the
    prefill runs eagerly and keeps no graph."""
    _, _, tcfg, tparams, embeds, route, seg = _backbone("float32")
    args = _port_args(tcfg, embeds, route, seg)
    graphs = pg.PrefillGraphs(admissions=3)

    def both():
        logits, cache = pg.prefill(tparams, tcfg, *args, S, graphs=graphs)
        chunked, admitted = tgen.prefill_chunked(
            tparams, tcfg, args[0][:1], route[:1], args[2], LENGTHS[:1], S,
            chunk=5, graphs=graphs)
        return logits.clone(), chunked.clone(), cache, admitted
    with torch.no_grad():
        want, _ = tgen._prefill(tparams, tcfg, *args, S)
        want_chunk, _ = tgen.prefill_chunked(
            tparams, tcfg, args[0][:1], route[:1], args[2], LENGTHS[:1], S,
            chunk=5)
        plain = pg.PrefillGraph(tparams, tcfg, graphs.cache(
            tparams, tcfg, 2, S, False), args[0], routed=True)
        with tp.scope(gloo_group):
            for _ in range(2):  # eager, then the capture's call
                logits, chunked, cache, admitted = both()
                assert torch.equal(logits, want)
                assert torch.equal(chunked, want_chunk)
            assert len(graphs) == 2
            one_shot = graphs.one_shot.values()[0]
            assert one_shot.group is gloo_group and one_shot.calls == 2
            with pytest.raises(RuntimeError, match="model group"):
                plain(*args[:1], args[1], args[3], args[4])
        no_group = both()
        assert len(graphs) == 4
        assert no_group[2] is not cache and no_group[3] is not admitted
        with tp.scope(dist.new_group([0])):
            assert torch.equal(both()[0], want) and len(graphs) == 6
    with torch.enable_grad():
        logits, _ = pg.prefill(tparams, tcfg, *args, S, graphs=graphs)
    assert torch.equal(logits.detach(), want) and len(graphs) == 6


# ------------------------------------------------------- towers

def _four_towers():
    """A JAX model with the four MCUB-4 tower kinds at their test sizes
    (randomized weights) and the port's model on the same weights."""
    cfg = jax_tiny_config(mm_vision_encoder="test:32x2",
                          mm_audio_encoder="test:16x2",
                          mm_video_encoder="test:32x3",
                          mm_point_encoder="test:16x2", mm_hidden_size=32)
    return _tower_models(cfg)


def _tower_models(cfg):
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(3))
    for i, enc in enumerate(jm.encoders.values()):
        enc.params = jax.tree.map(jnp.asarray, _randomize(enc.params, i))
    return jm, model_from_jax(_numpy_model(jm), device="cpu")


def _tower_inputs(modal, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)
    if modal == "audio":
        pad = np.zeros((2, 64), bool)
        pad[1, 40:] = True
        return {"audio_inputs": rnd(2, 64, 8), "audio_padding_mask": pad}
    return {"vision": rnd(2, 28, 28, 3), "video": rnd(2, 2, 28, 28, 3),
            "point": np.concatenate([rnd(2, 64, 3), rng.random((2, 64, 3))],
                                    -1).astype(np.float32)}[modal]


def _check_tower(jm, tm, modal, tol):
    """``encode_tower`` through the model's tower graphs, three calls of
    one shape: equal to the tower's eager encode exactly and to the JAX
    tower's jitted ``_encode`` within ``tol``."""
    enc, jenc = tm.encoders[modal], jm.encoders[modal]
    tm.tower_graphs.clear()
    for seed in range(3):
        raw = _tower_inputs(modal, seed)
        got = tm.encode_tower(modal, raw)
        graphs, tm.tower_graphs = tm.tower_graphs, None
        try:
            eager = tm.encode_tower(modal, raw)
        finally:
            tm.tower_graphs = graphs
        assert torch.equal(got, eager)
        want = jenc.encode(**raw) if isinstance(raw, dict) \
            else jenc.encode(raw)
        want = np.asarray(want[0] if isinstance(want, tuple) else want)
        if modal == "video":
            want = want.reshape(want.shape[0], -1, want.shape[-1])
        _assert_close(got, want, tol)
    (graph,) = tm.tower_graphs._graphs.values()
    assert graph.calls == 3 and graph.tower is enc


@pytest.fixture(scope="module")
def four_towers():
    return _four_towers()


@pytest.mark.parametrize("modal", ["vision", "audio", "video", "point"])
def test_tower_graphs_equal_eager_encode_and_jax(four_towers, modal):
    """CLIP, BEATs (with a padding mask), LanguageBind video and PointBERT
    (whose sampling loop a card capture takes inside the tower's graph)."""
    jm, tm = four_towers
    _check_tower(jm, tm, modal, FP32_TOL)


@pytest.mark.parametrize("modal,spec", [("vision", "eva-test:32x2"),
                                        ("audio", "imagebind-test:16x2")])
def test_eva_and_imagebind_tower_graphs_equal_eager_and_jax(modal, spec):
    import importlib
    jm, tm = _tower_models(jax_tiny_config(
        **{f"mm_{modal}_encoder": spec}, mm_hidden_size=32))
    if modal == "audio":  # ImageBind takes its processor's mel clips
        jproc = importlib.import_module(
            "modelcompose_tpu.models.audio_imagebind")
        mel = jproc.ImageBindAudioProcessor(jm.encoders[modal].cfg)(
            np.random.default_rng(5).normal(size=48000).astype(np.float32)
            * 0.1)
        tm.tower_graphs.clear()
        outs = [tm.encode_tower(modal, mel + np.float32(0.01 * i))
                for i in range(3)]
        for i, got in enumerate(outs):
            want = np.asarray(jm.encoders[modal].encode(
                mel + np.float32(0.01 * i)))
            _assert_close(got, want, FP32_TOL)
            assert torch.equal(got, tm.encoders[modal].encode(
                mel + np.float32(0.01 * i)))
        return
    _check_tower(jm, tm, modal, FP32_TOL)


def test_clip_text_tower_graph_equals_eager_and_jax():
    """The text encoder of ``retrieval`` through ``TowerGraphs``: equal to
    its eager encode and the JAX encoder's within 1e-5; a batch of another
    shape gets its own graph; the LRU keeps ``limit``."""
    tree = _randomized(5)
    jp = jax.tree.map(jnp.asarray, tree)
    enc = ttext.ClipTextEncoder(TEXT_CFG, params=params_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu"))
    jenc = jtext.ClipTextEncoder(_jcfg(), params=jp)
    graphs = TowerGraphs(limit=2)
    ids, mask = _ids(6)
    for _ in range(2):
        got = graphs.encode(enc, ids, mask)
        assert torch.equal(got, enc.encode(ids, mask))
        _assert_close(got, jenc.encode(ids, mask), FP32_TOL)
    graphs.encode(enc, ids[:2], mask[:2])
    graphs.encode(enc, ids[:1], mask[:1])
    assert len(graphs) == 2  # the first shape's graph went
