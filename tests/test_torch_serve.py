"""The port's serving stack: ``MultimodalLM.generate_stream``, the model
worker with both engines, the demo app, the web UI through the controller,
and the terminal CLI, against the JAX package where the two can meet.

The JAX and the port's models share weights (the JAX trees converted by
``modelcompose_tpu_torch.convert``) and run at fp32 on the CPU: greedy
event sequences, wire chunks and CLI answers must be identical.  The
remaining cases port tests/test_serve.py onto the port's worker (fake
models for the wire plumbing, a real tiny model where decode steps are
counted).  HTTP goes through aiohttp's ``TestClient``.
"""

import base64
import dataclasses
import importlib
import io
import json
import sys
import threading
import time
import zlib

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from modelcompose_tpu.config import tiny_test_config as jax_tiny_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.core import generate as tgen
from modelcompose_tpu_torch.serve import model_worker as tworker
from tests import fake_tokenizer
from tests import torch_async
from tests.fake_tokenizer import FakeLlamaTokenizer
from tests.test_torch_generate import _numpy_model

jworker = importlib.import_module("modelcompose_tpu.serve.model_worker")
jcli = importlib.import_module("modelcompose_tpu.serve.cli")
jloader = importlib.import_module("modelcompose_tpu.models.loader")
IMG = MODAL_TOKEN_INDEXES["vision"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fixed_token_ids(monkeypatch):
    """The fake tokenizer's builtin hash is salted per process: crc32 fixes
    the ids, so every run asks the same prompts (a salt that made the tiny
    model answer EOS early cut the wire chunks short)."""
    monkeypatch.setattr(fake_tokenizer, "hash",
                        lambda w: zlib.crc32(w.encode()), raising=False)


@pytest.fixture(scope="module")
def pair():
    """A tiny vision model in both packages, the port's converted from the
    JAX one."""
    cfg = jax_tiny_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                          mm_projector_type="mlp2x_gelu")
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(0))
    return jm, model_from_jax(_numpy_model(jm), device="cpu")


def _with_eos(model, eos):
    model.cfg = dataclasses.replace(model.cfg, eos_token_id=eos)
    return model


def _stream_events(model, ids, inputs, budgets, cancel_after):
    """Every (row, event) ``generate_stream`` emits, greedy; row 1 is
    cancelled once it has ``cancel_after`` tokens."""
    events, seen = [], [0] * len(ids)

    def emit(i, ev):
        events.append((i, ev[0], ev[1]))
        seen[i] += ev[0] == "token"
    model.generate_stream(ids, inputs, max_new_tokens=budgets,
                          temperatures=[0.0] * len(ids), emit=emit,
                          rng_seed=0, bucket_len=64,
                          cancelled=lambda i: i == 1
                          and seen[1] >= cancel_after)
    return events


def _rows(seed=3):
    pixels = np.random.default_rng(seed).normal(
        0, 1, (2, 28, 28, 3)).astype(np.float32)
    ids = [np.array([1, 5, IMG, 9, 10, 11]), np.array([1, IMG, 7]),
           np.array([1, 20, 21, 22])]
    return ids, {"vision": pixels}


@pytest.mark.parametrize("eos_step", [None, 2])
def test_generate_stream_events_match_jax(pair, eos_step):
    """A 3-row greedy batch with budgets 6, 9 and 4, row 1 cancelled after
    3 tokens: the port emits JAX's events, event for event.  With
    ``eos_step`` the EOS is row 2's token at that step, so that row ends on
    EOS (and any other row that draws it)."""
    jm, tm = pair
    ids, inputs = _rows()
    budgets = [6, 9, 4]
    eos = -1
    try:
        if eos_step is not None:
            first = _stream_events(_with_eos(jm, -1), ids, inputs, budgets,
                                   99)
            eos = [e[2] for e in first if e[0] == 2][eos_step]
        want = _stream_events(_with_eos(jm, eos), ids, inputs, budgets, 3)
        got = _stream_events(_with_eos(tm, eos), ids, inputs, budgets, 3)
    finally:
        _with_eos(jm, 2), _with_eos(tm, 2)
    assert got == want
    dones = [e for e in got if e[1] == "done"]
    assert sorted(e[0] for e in dones) == [0, 1, 2]
    counts = [sum(1 for e in got if e[0] == r and e[1] == "token")
              for r in range(3)]
    assert counts[1] == 3 and counts[0] <= 6
    assert counts[2] == (eos_step if eos_step is not None else 4)


def test_generate_stream_sampled_draws_come_from_the_seeded_generator(pair):
    """Sampled rows draw from a ``torch.Generator`` seeded by ``rng_seed``
    (the JAX package draws from its PRNG keys, so the streams differ): the
    same seed gives the same events, and a nucleus of one token (top-p
    1e-6) gives the greedy events at any temperature."""
    _, tm = pair
    ids, inputs = _rows()

    def events(temps, top_ps, seed=7):
        out = []
        tm.generate_stream(ids, inputs, max_new_tokens=[5, 5, 5],
                           temperatures=temps, top_ps=top_ps, rng_seed=seed,
                           bucket_len=64,
                           emit=lambda i, e: out.append((i,) + e))
        return out
    sampled = events([1.5] * 3, [1.0] * 3)
    assert sampled == events([1.5] * 3, [1.0] * 3)
    assert events([1.5] * 3, [1e-6] * 3) == events([0.0] * 3, [1.0] * 3)


def test_generate_stream_zero_budgets_skip_the_prefill(pair, monkeypatch):
    _, tm = pair
    monkeypatch.setattr(tgen, "_prefill", None)  # must not be reached
    events = []
    tm.generate_stream([np.array([1, 5])] * 2, {}, max_new_tokens=[0, -1],
                       temperatures=[0.0, 0.0],
                       emit=lambda i, e: events.append((i, e)))
    assert events == [(0, ("done", None)), (1, ("done", None))]


# ------------------------------------------------------- worker wire chunks

def _loader_of(model):
    def loader(model_path, model_base, model_name):
        return FakeLlamaTokenizer(), model, model.modal_processors(), 2048
    return loader


@pytest.mark.parametrize("continuous", [False, True])
def test_worker_wire_chunks_match_jax(pair, continuous):
    """One greedy request through each package's worker (the BatchingEngine
    or the slot engine): the same b"\\0"-delimited JSON chunks."""
    jm, tm = pair
    request = {"prompt": "USER: hello there ASSISTANT:", "max_new_tokens": 6,
               "temperature": 0.0}
    kw = dict(no_register=True, continuous_batching=continuous,
              slot_cache_len=64)
    jw = jworker.ModelWorker("http://c", "http://w", "m-multimodal", "b",
                             loader=_loader_of(jm), **kw)
    tw = tworker.ModelWorker("http://c", "http://w", "m-multimodal", "b",
                             loader=_loader_of(tm), device="cpu", **kw)
    try:
        want = list(jw.generate_stream(dict(request)))
        got = list(tw.generate_stream(dict(request)))
        # the HTTP route adds nothing to the chunks (the card's smoke reads
        # them from generate_stream, with no HTTP hop)
        async def http():
            async with TestClient(TestServer(tworker.build_app(tw))) as c:
                r = await c.post("/worker_generate_stream", json=request)
                return [p + b"\0" for p in (await r.read()).split(b"\0")
                        if p]
        routed = torch_async.run(http())
    finally:
        for w in (jw, tw):
            if continuous:
                w.engine.stop()
    assert got == want == routed
    assert len(got) == 6 and all(c.endswith(b"\0") for c in got)
    assert json.loads(got[-1][:-1])["error_code"] == 0


class FakeModel:
    def generate(self, ids, modal_inputs, max_new_tokens=16,
                 temperature=0.0, generator=None, num_beams=1, top_p=1.0):
        return [[11, 12, 13]]

    def generate_stream(self, ids, modal_inputs, *, max_new_tokens,
                        temperatures, emit, top_ps=None, rng_seed=None,
                        bucket_len=None, cancelled=None):
        for b in range(len(ids)):
            for tok in (11, 12, 13):
                emit(b, ("token", tok))
            emit(b, ("done", None))


class FakeTokenizer:
    bos_token_id = 1

    def __call__(self, text):
        class R:
            input_ids = [1, 5, 6]
        return R()

    def decode(self, ids, skip_special_tokens=True):
        return "hello world"


def _fake_loader(model_path, model_base, model_name):
    return FakeTokenizer(), FakeModel(), {}, 2048


def _fake_worker(**kw):
    return tworker.ModelWorker("http://c", "http://w", "path-multimodal",
                               "base", no_register=True, device="cpu",
                               loader=kw.pop("loader", _fake_loader), **kw)


def test_worker_generate_stream_chunks_and_http():
    worker = _fake_worker()
    chunks = list(worker.generate_stream(
        {"prompt": "hi", "max_new_tokens": 8, "temperature": 0}))
    assert all(c.endswith(b"\0") for c in chunks)
    last = json.loads(chunks[-1][:-1])
    assert last["error_code"] == 0 and "hello world" in last["text"]

    async def run():
        async with TestClient(TestServer(tworker.build_app(worker))) as client:
            r = await client.post("/worker_get_status", json={})
            assert (await r.json())["model_names"] == ["path-multimodal"]
            r = await client.post("/worker_generate_stream",
                                  json={"prompt": "hi", "temperature": 0})
            parts = [p for p in (await r.read()).split(b"\0") if p]
            assert json.loads(parts[-1])["error_code"] == 0
    torch_async.run(run())


def test_worker_reports_engine_errors_in_band():
    class Broken(FakeModel):
        def generate_stream(self, *a, **kw):
            raise RuntimeError("boom")

    def loader(mp, mb, name):
        return FakeTokenizer(), Broken(), {}, 2048
    chunks = list(_fake_worker(loader=loader).generate_stream(
        {"prompt": "hi"}))
    assert len(chunks) == 1
    last = json.loads(chunks[0][:-1])
    assert last["error_code"] == 1 and "boom" in last["text"]


def test_demo_app_index_and_generate():
    from modelcompose_tpu_torch.serve.demo_app import DemoApp, build_app

    class DemoModel:
        def generate(self, ids, modal_inputs, max_new_tokens=128,
                     num_beams=1):
            return [[7, 8]]

    def loader(mp, mb, name):
        return FakeTokenizer(), DemoModel(), {}, 2048
    demo = DemoApp("merged-multimodal", "base", loader=loader)

    async def run():
        async with TestClient(TestServer(build_app(demo))) as client:
            r = await client.get("/")
            assert r.status == 200 and "ModelCompose" in await r.text()
            r = await client.post("/generate", data={"question": "what?"})
            assert "hello world" in await r.text()
    torch_async.run(run())


def test_web_server_chat_flow():
    """Web UI -> controller -> the port's worker, the full stream."""
    from modelcompose_tpu_torch.serve.controller import Controller
    from modelcompose_tpu_torch.serve.controller import build_app as ctrl_app
    from modelcompose_tpu_torch.serve.web_server import WebServer
    from modelcompose_tpu_torch.serve.web_server import build_app as web_app

    async def run():
        worker_server = TestServer(tworker.build_app(_fake_worker()))
        await worker_server.start_server()
        controller = Controller()
        controller.register_worker(
            f"http://{worker_server.host}:{worker_server.port}", True,
            {"model_names": ["path-multimodal"], "speed": 1,
             "queue_length": 0})
        ctrl_server = TestServer(ctrl_app(controller))
        await ctrl_server.start_server()
        web = web_app(WebServer(f"http://{ctrl_server.host}:"
                                f"{ctrl_server.port}"))
        async with TestClient(TestServer(web)) as client:
            r = await client.get("/")
            assert "path-multimodal" in await r.text()
            r = await client.post("/chat", data={"model": "path-multimodal",
                                                 "message": "hi"})
            assert "hello world" in await r.text()
        await worker_server.close()
        await ctrl_server.close()
    torch_async.run(run())


def test_batching_engine_coalesces_requests():
    seen_batches = []

    def stream(requests, emit):
        seen_batches.append(len(requests))
        for i, r in enumerate(requests):
            emit(i, ("token", int(r["prompt"])))
            emit(i, ("done", None))

    engine = tworker.BatchingEngine(stream, max_batch=4, batch_wait_ms=50)
    results = {}

    def call(i):
        q = engine.submit({"prompt": str(i)})
        toks = []
        while True:
            kind, payload = q.get(timeout=30)
            if kind == "done":
                break
            toks.append(payload)
        results[i] = toks

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert results == {i: [i] for i in range(4)}
    assert max(seen_batches) >= 2  # coalesced


def test_batching_engine_error_propagates():
    def stream(requests, emit):
        raise RuntimeError("boom")

    engine = tworker.BatchingEngine(stream, max_batch=2, batch_wait_ms=1)
    kind, payload = engine.submit({"prompt": "x"}).get(timeout=30)
    assert kind == "error" and isinstance(payload, RuntimeError)


def test_streaming_chunks_arrive_before_generation_completes():
    """A chunk reaches the client over a live socket while the model still
    decodes (the reference's TextIteratorStreamer semantics)."""
    finished = threading.Event()

    class SlowStreamModel(FakeModel):
        def generate_stream(self, ids, modal_inputs, **kw):
            for tok in (11, 12, 13, 14):
                kw["emit"](0, ("token", tok))
                time.sleep(0.15)  # still decoding after each token
            kw["emit"](0, ("done", None))
            finished.set()

    class CountingTokenizer(FakeTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return "tok " * len(ids)

    def loader(mp, mb, name):
        return CountingTokenizer(), SlowStreamModel(), {}, 2048
    worker = _fake_worker(loader=loader)

    async def run():
        async with TestClient(TestServer(tworker.build_app(worker))) as client:
            r = await client.post("/worker_generate_stream",
                                  json={"prompt": "hi", "temperature": 0,
                                        "max_new_tokens": 4})
            early, chunks = False, []
            async for piece in r.content.iter_any():
                chunks.extend(p for p in piece.split(b"\0") if p)
                early = early or (bool(chunks) and not finished.is_set())
            assert early, "no chunk arrived before generation completed"
            assert len(chunks) >= 2
            assert json.loads(chunks[-1])["error_code"] == 0
    torch_async.run(run())


def test_media_requests_batch_as_one_packed_generation(pair):
    """Two image requests coalesce into ONE packed generation, their
    images concatenated in request order, and each still gets its answer."""
    from PIL import Image
    _, tm = pair
    calls = []
    orig = tm.generate_stream

    def counting(ids, modal_inputs, **kw):
        calls.append((len(ids), {m: np.asarray(v).shape[0]
                                 for m, v in modal_inputs.items()}))
        return orig(ids, modal_inputs, **kw)

    worker = _fake_worker(loader=_loader_of(tm))
    worker.engine = tworker.BatchingEngine(worker._stream_batch, max_batch=5,
                                           batch_wait_ms=300)
    buf = io.BytesIO()
    Image.new("RGB", (28, 28), (255, 0, 0)).save(buf, format="PNG")
    img_b64 = base64.b64encode(buf.getvalue()).decode()
    results = {}

    def call(i):
        results[i] = list(worker.generate_stream(
            {"prompt": f"<image>\nquestion {i}", "max_new_tokens": 3,
             "temperature": 0, "modal_inputs": {"vision": [img_b64]}}))

    tm.generate_stream = counting
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        del tm.generate_stream
    assert len(results) == 2
    for chunks in results.values():
        assert json.loads(chunks[-1][:-1])["error_code"] == 0
    assert any(n == 2 and feats.get("vision") == 2 for n, feats in calls), \
        calls


@pytest.fixture
def counted_worker(pair, monkeypatch):
    """A worker over the real tiny model whose decode steps are counted
    (the BatchingEngine's generate_stream calls core.generate._decode_step);
    ``stop`` makes the tokenizer's text complete a stop string at the
    third token."""
    _, tm = pair
    steps = [0]
    orig = tgen._decode_step

    def counting(*a, **kw):
        steps[0] += 1
        return orig(*a, **kw)
    monkeypatch.setattr(tgen, "_decode_step", counting)
    eos = tm.cfg.eos_token_id
    _with_eos(tm, -1)  # a random model: no natural EOS

    class StopTok(FakeLlamaTokenizer):
        stop = False

        def decode(self, ids, skip_special_tokens=True):
            n = len(np.asarray(ids).tolist())
            if self.stop and n >= 3:
                return "x" * n + "STOP trailing"
            return "x" * n

    tok = StopTok()

    def loader(mp, mb, name):
        return tok, tm, {}, 2048
    yield _fake_worker(loader=loader), steps, tok
    _with_eos(tm, eos)


def test_stop_string_cancels_packed_generation(counted_worker):
    worker, steps, tok = counted_worker
    tok.stop = True
    chunks = list(worker.generate_stream(
        {"prompt": "hi", "stop": "STOP", "max_new_tokens": 50,
         "temperature": 0}))
    last = json.loads(chunks[-1][:-1])
    assert last["error_code"] == 0
    assert "STOP" not in last["text"] and "trailing" not in last["text"]
    time.sleep(0.5)  # the engine thread sees the cancel
    assert steps[0] <= 10, steps[0]


def test_client_disconnect_cancels_packed_generation(counted_worker):
    worker, steps, _ = counted_worker
    gen = worker.generate_stream({"prompt": "hi", "max_new_tokens": 50,
                                  "temperature": 0})
    next(gen)
    next(gen)
    gen.close()  # GeneratorExit -> finally -> the cancel event
    time.sleep(1.0)
    assert steps[0] <= 10, steps[0]


def test_external_cancel_event_releases_row(counted_worker):
    worker, steps, _ = counted_worker
    cancel = threading.Event()
    gen = worker.generate_stream({"prompt": "hi", "max_new_tokens": 50,
                                  "temperature": 0}, cancel=cancel)
    try:
        next(gen)
        cancel.set()  # the endpoint's cancellation, no close()
        time.sleep(1.0)
    finally:
        gen.close()
    assert steps[0] <= 10, steps[0]


def test_worker_main_refuses_tensor_parallel(tmp_path, monkeypatch):
    """``--tp 2`` outside a process group of 2 is refused: the worker joins
    the group torchrun describes, and without one it names torchrun."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        tworker.main(["--model-path", str(tmp_path / "m-multimodal"),
                      "--model-base", str(tmp_path), "--tp", "2",
                      "--device", "cpu", "--no-register"])


def test_worker_flags_match_jax():
    """Every flag of the JAX worker, with its default, plus --device."""
    import argparse

    def flags(parser):
        return {a.dest: a.default for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}
    captured = {}

    def grab(self, *a, **kw):
        captured["parser"] = self
        raise SystemExit(0)
    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jworker.main()
    finally:
        argparse.ArgumentParser.parse_args = orig
    want = flags(captured["parser"])
    got = flags(tworker.build_arg_parser())
    assert got.pop("device") is None and got == want


# ------------------------------------------------------------------- CLI

def test_cli_answers_match_jax(pair, tmp_path, monkeypatch, capsys):
    """Two greedy turns piped on stdin, with an image: the port's CLI
    prints the JAX CLI's lines."""
    from PIL import Image

    from modelcompose_tpu_torch.models import loader as tloader
    from modelcompose_tpu_torch.serve import cli as tcli
    jm, tm = pair
    image = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (28, 28, 3), dtype=np.uint8)).save(image)
    argv = ["--model-path", str(tmp_path / "m-multimodal"), "--model-base",
            str(tmp_path), "--image-file", str(image), "--temperature", "0",
            "--max-new-tokens", "5"]
    tok = FakeLlamaTokenizer()
    monkeypatch.setattr(jloader, "load_pretrained_model",
                        lambda *a, **kw: (tok, jm, jm.modal_processors(),
                                          2048))
    monkeypatch.setattr(tloader, "load_pretrained_model",
                        lambda *a, **kw: (tok, tm, tm.modal_processors(),
                                          2048))
    outs = []
    for run in (lambda: (monkeypatch.setattr(sys, "argv", ["cli"] + argv),
                         jcli.main()),
                lambda: tcli.main(argv + ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO("what is it?\nsure?\n"))
        run()
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[0].count("ASSISTANT: t") == 2
