"""The compiled decode: ``core/decode_graph.DecodeGraph`` and every decoder
that goes through it (``generate(device_loop=True)``, beam search, the slot
pool and ``generate_stream``'s cache), and PointBERT's sampling loop,
against the JAX package and the port's eager decode.

On the CPU a ``DecodeGraph`` runs the captured step eagerly into the same
static buffers and cache the card's graph reads by address, so these tests
hold the buffer logic: the ids, and the addresses that must not move.  The
models are the tiny fp32 ones of the other parity tests (the JAX weights
moved by ``modelcompose_tpu_torch.convert``), where the two packages differ
only in summation order: greedy and beam ids are bit-exact.  The graph
itself (capture, replay, K2 inside it) is held on the card by
tests/test_torch_kernels_cuda.py.
"""

import datetime
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from modelcompose_tpu.core import beam as jbeam
from modelcompose_tpu.core import generate as jgenerate

from modelcompose_tpu_torch.core import beam, decode_graph
from modelcompose_tpu_torch.core import generate as tgen
from modelcompose_tpu_torch.core.decode_graph import DecodeGraph, DecodeGraphs
from modelcompose_tpu_torch.models import point_bert
from modelcompose_tpu_torch.parallel import tp
from modelcompose_tpu_torch.serve import slot_engine as tslot
from tests import torch_async
from tests.test_torch_beam import AUDIO, _core_args, _prompts
from tests.test_torch_generate import IMG, _batch, _pair
from tests.test_torch_slot_engine import _schedule

jslot = importlib.import_module("modelcompose_tpu.serve.slot_engine")
jpoint = importlib.import_module("modelcompose_tpu.models.point_bert")
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vision():
    return _pair(1)  # seed 1: no row meets EOS within STEPS


@pytest.fixture(scope="module")
def audio_vision():
    return _pair(2, **AUDIO)


def _core(model, ids, inputs, bucket_len=32):
    """(embeds, generate's keyword arguments) of a packed batch."""
    embeds, plan = model.prepare_batch(ids, inputs, bucket_len=bucket_len)
    return embeds, dict(lengths=plan.lengths, route_ids=plan.route_ids,
                        routing_table=model.routing_table,
                        segment_ids=plan.segment_ids)


def _port(tm, ids, inputs, bucket_len=32, **kw):
    embeds, args = _core(tm, ids, inputs, bucket_len)
    with torch.no_grad():
        return tgen.generate(tm.params, tm.cfg, embeds, **args, **kw)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("fold_decode", [False, "dense", "concat"])
def test_device_loop_greedy_ids_match_jax_decode_loop(vision, fold_decode,
                                                      kv_quant):
    """The JAX ``generate`` at its default ``device_loop=True`` (the whole
    loop one compiled ``_decode_loop``) against the port's through a
    ``DecodeGraph``, and against the port's eager loop."""
    jm, tm = vision
    ids, inputs = _batch()
    embeds, args = _core(jm, ids, inputs)
    want = jgenerate.generate(
        jm.params, jm.cfg, embeds, max_new_tokens=STEPS,
        fold_decode=True if fold_decode == "concat" else fold_decode,
        kv_quant=kv_quant, **args)
    kw = dict(max_new_tokens=STEPS, fold_decode=fold_decode,
              kv_quant=kv_quant)
    got = _port(tm, ids, inputs, device_loop=True, **kw)
    eager = _port(tm, ids, inputs, device_loop=False, **kw)
    assert got == want == eager
    assert max(len(r) for r in got) == STEPS


@pytest.mark.parametrize("top_p", [1.0, 0.5])
def test_device_loop_sampled_ids_equal_the_eager_loop(vision, top_p):
    """The token choice stays outside the graph: for one seed the draws
    are the eager loop's, draw for draw."""
    _, tm = vision
    ids, inputs = _batch()
    runs = {}
    for loop in (True, False):
        runs[loop] = [_port(tm, ids, inputs, max_new_tokens=STEPS,
                            temperature=0.9, top_p=top_p, device_loop=loop,
                            generator=torch.Generator().manual_seed(seed))
                      for seed in (0, 1)]
    assert runs[True] == runs[False]
    assert runs[True][0] != runs[True][1]  # the seed matters


class _Watch:
    """Wraps ``DecodeGraph.__call__``: the addresses of every buffer a
    graph reads or writes, at every step."""

    def __init__(self, monkeypatch):
        self.seen = []
        call = DecodeGraph.__call__

        def watched(graph, tokens, kv_lens):
            out = call(graph, tokens, kv_lens)
            self.seen.append((id(graph), out.data_ptr(), tuple(
                t.data_ptr() for t in [graph.tokens, graph.kv_lens]
                + graph.cache.tensors())))
            return out
        monkeypatch.setattr(DecodeGraph, "__call__", watched)


def test_buffers_keep_their_addresses_across_steps_and_requests(
        vision, monkeypatch):
    """The address contract of a graph: one graph serves two requests of
    one shape, and its inputs, logits and cache never move."""
    _, tm = vision
    watch = _Watch(monkeypatch)
    graphs = DecodeGraphs(2)
    ids, inputs = _batch()
    first = _port(tm, ids, inputs, max_new_tokens=STEPS, kv_quant=True,
                  graphs=graphs)
    again = _port(tm, ids, inputs, max_new_tokens=STEPS, kv_quant=True,
                  graphs=graphs)
    assert first == again
    assert len(graphs) == 1
    assert len(watch.seen) == 2 * (STEPS - 1)
    assert len(set(watch.seen)) == 1


def test_model_reuses_its_graph_and_new_params_drop_it(vision):
    _, tm = vision
    tm.decode_graphs.clear()
    ids, inputs = _batch()
    a = tm.generate(ids, inputs, max_new_tokens=4, bucket_len=32)
    (graph,) = tm.decode_graphs._graphs.values()
    b = tm.generate(ids, inputs, max_new_tokens=4, bucket_len=32)
    assert a == b and list(tm.decode_graphs._graphs.values()) == [graph]
    tm.generate(ids, inputs, max_new_tokens=6, bucket_len=32)  # new shape
    assert len(tm.decode_graphs) == 2
    tm.generate(ids, inputs, max_new_tokens=8, bucket_len=32)
    assert len(tm.decode_graphs) == 2  # bounded: the oldest went
    assert graph not in tm.decode_graphs._graphs.values()
    tm.params = tm.params  # new weights: every graph read the old ones
    assert len(tm.decode_graphs) == 0


def test_a_fold_made_in_the_call_keeps_no_graph(vision):
    """'concat' and 'dense' build their params inside the call: the
    graph over them goes with the call, nothing is retained."""
    _, tm = vision
    tm.decode_graphs.clear()
    ids, inputs = _batch()
    for fold in ("concat", "dense"):
        tm.generate(ids, inputs, max_new_tokens=4, bucket_len=32,
                    fold_decode=fold)
    assert len(tm.decode_graphs) == 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_shorter_request_into_a_used_cache_gives_fresh_cache_ids(
        vision, kv_quant):
    """A request with long prompts, then one with short prompts in the same
    bucket (so the same cache shape): the reused cache is prefilled to what
    a fresh one holds (rows past the bucket zeroed), and the ids are a
    fresh cache's."""
    _, tm = vision
    long_ids = [np.concatenate([[1, IMG], np.arange(5, 26)]),
                np.concatenate([[1], np.arange(30, 45), [IMG]])]
    short_ids = [np.array([1, IMG, 7]), np.array([1, 9, 10, IMG])]
    pixels = np.random.default_rng(5).normal(
        0, 1, (2, 28, 28, 3)).astype(np.float32)
    inputs = {"vision": pixels}
    graphs = DecodeGraphs(1)
    kw = dict(max_new_tokens=STEPS, kv_quant=kv_quant)
    _port(tm, long_ids, inputs, graphs=graphs, **kw)
    (graph,) = graphs._graphs.values()
    assert any(t[:, :, 32:].any() for t in graph.cache.tensors())
    got = _port(tm, short_ids, inputs, graphs=graphs, **kw)
    assert len(graphs) == 1 and next(iter(graphs._graphs.values())) is graph
    fresh = _port(tm, short_ids, inputs, device_loop=False, **kw)
    assert got == fresh

    embeds, args = _core(tm, short_ids, inputs)
    cache_len = 32 + STEPS
    prefill = dict(route_ids=torch.as_tensor(args["route_ids"]),
                   routing_table=torch.as_tensor(tm.routing_table),
                   segment_ids=torch.as_tensor(args["segment_ids"]),
                   lengths=torch.as_tensor(args["lengths"]))
    with torch.no_grad():
        want, new = tgen._prefill(tm.params, tm.cfg, embeds,
                                  max_len=cache_len, kv_quant=kv_quant,
                                  **prefill)
        logits, used = tgen._prefill(tm.params, tm.cfg, embeds,
                                     max_len=cache_len, kv_quant=kv_quant,
                                     cache=graph.cache, **prefill)
    assert used is graph.cache and torch.equal(logits, want)
    for a, b in zip(used.tensors(), new.tensors()):
        assert torch.equal(a, b)


def test_prefill_refuses_a_cache_of_another_shape(vision):
    _, tm = vision
    ids, inputs = _batch()
    embeds, args = _core(tm, ids, inputs)
    other = DecodeGraph(tm.params, tm.cfg, 2, 40).cache
    with pytest.raises(ValueError, match="positions"):
        tgen._prefill(tm.params, tm.cfg, embeds, args["route_ids"],
                      tm.routing_table, torch.as_tensor(args["segment_ids"]),
                      torch.as_tensor(args["lengths"]), 44, cache=other)


def _beam_both(pair, ids, inputs, device_loop, graphs=None, **kw):
    jm, tm = pair
    j_emb, j_kw = _core_args(jm, ids, inputs)
    with torch.no_grad():
        t_emb, t_kw = _core_args(tm, ids, inputs)
        got = beam.beam_generate(tm.params, tm.cfg, t_emb, **t_kw,
                                 device_loop=device_loop, graphs=graphs,
                                 **kw)
    want = jbeam.beam_generate(jm.params, jm.cfg, j_emb, **j_kw, **kw)
    return got, want


@pytest.mark.parametrize("device_loop", [True, False])
def test_beam_search_through_the_graph_matches_jax(audio_vision,
                                                   device_loop):
    """Beam steps replay a graph of num_beams rows; the parent-beam gather
    reorders that graph's cache in place.  Ids equal the JAX package's."""
    graphs = DecodeGraphs(1)
    for ids, inputs in _prompts():
        got, want = _beam_both(audio_vision, ids, inputs, device_loop,
                               graphs=graphs, num_beams=3,
                               max_new_tokens=8)
        assert got == want, (ids, got, want)
    if device_loop:
        (graph,) = graphs._graphs.values()
        assert graph.tokens.shape == (3,)


def test_beam_sampling_through_the_graph_matches_jax(audio_vision):
    """Beam sampling's bookkeeping with the same drawn candidates on both
    sides (the ``_draw_override`` hook of tests/test_torch_beam.py)."""
    _, tm = audio_vision
    rng = np.random.default_rng(11)
    draws = [rng.choice(3 * tm.cfg.vocab_size, 6, replace=False)
             for _ in range(8)]
    for ids, inputs in _prompts()[:2]:
        got, want = _beam_both(audio_vision, ids, inputs, True,
                               num_beams=3, max_new_tokens=8,
                               temperature=0.9, top_p=0.9,
                               _draw_override=draws)
        assert got == want, (ids, got, want)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_slot_pool_is_a_graph_and_its_schedule_matches_jax(kv_quant):
    """The slot pool is the cache of a graph made with it: admissions are
    spliced into that cache in place, every tick replays it, and the
    schedule's ids, kv_lens and logits are the JAX package's."""
    from tests.test_torch_slot_engine import jax_tiny_config, JaxLM
    from modelcompose_tpu_torch.convert import model_from_jax
    from tests.test_torch_generate import _numpy_model
    cfg = jax_tiny_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                          mm_projector_type="mlp2x_gelu", eos_token_id=-1)
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(0))
    tm = model_from_jax(_numpy_model(jm), device="cpu")
    want = _schedule(jslot.SlotDecoder(jm, max_slots=3, cache_len=64,
                                       kv_quant=kv_quant), chunk=16)
    dec = tslot.SlotDecoder(tm, max_slots=3, cache_len=64,
                            kv_quant=kv_quant, device="cpu")
    graph = dec.backbone.graphs[tslot.POOL]
    ptrs = [t.data_ptr() for t in graph.cache.tensors()]
    got = _schedule(dec, chunk=16)
    assert graph.cache is dec.cache
    assert [t.data_ptr() for t in dec.cache.tensors()] == ptrs
    assert dec.logits.data_ptr() != graph.logits.data_ptr()
    for (t, kv, lg), (wt, wkv, wlg) in zip(got, want):
        assert t == wt and kv == wkv
        np.testing.assert_allclose(lg, wlg, rtol=1e-5, atol=1e-5)


def test_generate_stream_reuses_the_stream_cache(vision):
    """Two streamed requests of one shape decode through one graph of the
    model's, whose cache they both fill; the events are greedy
    ``generate``'s ids."""
    _, tm = vision
    tm.decode_graphs.clear()
    ids, inputs = _batch()
    want = tm.generate(ids, inputs, max_new_tokens=5, bucket_len=32)
    tm.decode_graphs.clear()
    runs = []
    for _ in range(2):
        events = {0: [], 1: []}
        tm.generate_stream(ids, inputs, max_new_tokens=[5, 5],
                           temperatures=[0.0, 0.0], bucket_len=32,
                           emit=lambda b, ev: events[b].append(ev))
        runs.append([[v for k, v in events[b] if k == "token"]
                     for b in (0, 1)])
        assert len(tm.decode_graphs) == 1
        assert tm.serving.graphs == {}  # freed with the request
    assert runs[0] == runs[1] == want


@pytest.fixture
def gloo_group(tmp_path):
    """A gloo model group of this one process."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path}/rendezvous",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    yield dist.new_group([0])
    if made:
        dist.destroy_process_group()


def test_decode_graph_raises_under_a_model_group(vision, gloo_group):
    """A decode graph belongs to the model group it was made under: one
    made with no group raises when called under a group, one made under a
    group raises when called under none, and ``DecodeGraphs`` keys them
    apart, and apart from another group of the same ranks (a key without
    the group would replay a graph without its collectives, or with
    another group's).  Under a gloo group of one the model's
    ``generate(device_loop=True)`` decodes through a graph of that group,
    with the same ids as the eager decode under it and the no-group run."""
    _, tm = vision
    ids, inputs = _batch()
    graphs = DecodeGraphs(4)
    table = tm.decode_routing_table()

    def get():
        return graphs.get(tm.params, tm.cfg, 2, 40, routing_table=table)
    plain = get()
    with torch.no_grad():
        with tp.scope(gloo_group):
            grouped = get()
            assert grouped is not plain and get() is grouped
            assert (grouped.group, plain.group) == (gloo_group, None)
            with pytest.raises(RuntimeError, match="model group"):
                plain([3, 5], [4, 6])
            logits = grouped([3, 5], [4, 6]).clone()
        with pytest.raises(RuntimeError, match="model group"):
            grouped([3, 5], [4, 6])
        with tp.scope(dist.new_group([0])):
            assert get() not in (plain, grouped)
        assert get() is plain and len(graphs) == 3
        assert torch.equal(plain([3, 5], [4, 6]), logits)
    want = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
    tm.tp_group, tm._serving = gloo_group, None
    tm.decode_graphs.clear()
    try:
        got = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
        made = tm.decode_graphs.values()
        eager = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32,
                            device_loop=False)
    finally:
        tm.tp_group, tm._serving = None, None
        tm.decode_graphs.clear()
    assert got == eager == want
    assert [g.group for g in made] == [gloo_group] and made[0].calls > 1


@pytest.mark.parametrize("B,N,npoint", [(1, 256, 32), (2, 300, 64)])
def test_fps_indices_equal_the_jax_fori_loop(B, N, npoint):
    """The sampling loop (eager on the CPU, one graph replay on the card)
    against the JAX ``fori_loop``, ties included (a repeated point)."""
    xyz = np.random.default_rng(N).normal(size=(B, N, 3)).astype(np.float32)
    xyz[:, 7] = xyz[:, 3]
    want = np.asarray(jpoint.farthest_point_sample(jnp.asarray(xyz), npoint))
    got = point_bert.farthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_async_leaves_the_main_thread_its_event_loop():
    """The port's tests run coroutines through ``tests/torch_async.run``;
    unlike ``asyncio.run`` it leaves the thread's event loop alone, so a
    later ``asyncio.get_event_loop()`` in the main thread still works (the
    JAX package's tests/test_serve.py takes the loop that way)."""
    import subprocess
    import sys
    code = ("import asyncio\n"
            "from tests import torch_async\n"
            "async def two():\n"
            "    await asyncio.sleep(0)\n"
            "    return 2\n"
            "assert torch_async.run(two()) == 2\n"
            "loop = asyncio.get_event_loop()\n"
            "assert loop.run_until_complete(two()) == 2\n"
            "print('LOOP_OK')\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "LOOP_OK" in out.stdout, out.stderr
    assert torch_async.run(_two()) == 2


async def _two():
    return 2


def test_the_module_keeps_the_eager_step():
    """``core.generate._decode_step`` (the eager loop's, the smoke's and
    the serving followers') is the one the graph captures."""
    assert tgen._decode_step is decode_graph._decode_step
