"""The port's chunked prefill and slot engine against the JAX package.

``prefill_chunked`` and ``SlotDecoder`` run in both packages on the same
weights (the JAX trees converted by ``modelcompose_tpu_torch.convert``) and
the same numpy-seeded inputs, at fp32 on the CPU, where the two differ
only in summation order: logits and cache rows within 2e-5 (1e-5 for the
slot logits), greedy ids bit-exact, int8 cache rows within one step for
over 99% of entries.  ``ContinuousBatchingEngine`` is held to the port's
own solo ``generate`` on the cases of tests/test_slot_engine.py; every
wait there has its own deadline, so no case can hang the suite.
"""

import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import ROUTE_CLASS_INDEX
from modelcompose_tpu.config import tiny_test_config as jax_tiny_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.core import generate as jgen
from modelcompose_tpu.core.llama import init_params as jax_init_params
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

from modelcompose_tpu_torch import MultimodalLM, tiny_test_config
from modelcompose_tpu_torch.config import ModelConfig
from modelcompose_tpu_torch.convert import model_from_jax, params_from_jax
from modelcompose_tpu_torch.core import generate as tgen
from modelcompose_tpu_torch.core.llama import KVCache, quantize_kv
from modelcompose_tpu_torch.serve import slot_engine as tslot
from tests.test_torch_generate import _numpy_model

jslot = importlib.import_module("modelcompose_tpu.serve.slot_engine")

IMG = MODAL_TOKEN_INDEXES["vision"]
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- prefill_chunked

@pytest.fixture(scope="module")
def chunk_setup():
    """tests/test_chunked_prefill.py's setup: a tiny fp32 backbone with
    nonzero LoRA B, one right-padded prompt of 13 positions in 16 with a
    vision span; the port's params converted from the JAX ones."""
    cfg = jax_tiny_config(mm_vision_encoder="x", mm_hidden_size=8,
                          dtype="float32")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_b"] = jnp.asarray(
                rng.normal(0, 0.1, p["lora_b"].shape).astype(np.float32))
    embeds = (np.random.default_rng(2).normal(size=(1, 16, cfg.hidden_size))
              * 0.1).astype(np.float32)
    route = np.zeros((1, 16), np.int32)
    route[:, 2:5] = ROUTE_CLASS_INDEX["vision"]
    lengths = np.array([13], np.int32)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tcfg = ModelConfig.from_dict(cfg.to_dict())
    return cfg, params, tcfg, tparams, embeds, route, lengths


def _valid_rows(cache, n):
    return {part: np.asarray(getattr(cache, part))[:, :, :n]
            for part in ("k", "v")}


def _torch_rows(cache, n, key=None):
    out = {}
    for part in ("k", "v"):
        c = getattr(cache, part)
        c = c[key] if key else c
        out[part] = c[:, :, :n].float().numpy()
    return out


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("chunk", [4, 5, 7, 1])
def test_prefill_chunked_matches_jax_and_one_shot(chunk_setup, chunk, routed):
    cfg, params, tcfg, tparams, embeds, route, lengths = chunk_setup
    table = cfg.routing_table() if routed else None
    route = route if routed else None
    Lv = int(lengths[0])
    want_logits, want_cache = jgen.prefill_chunked(
        params, cfg, jnp.asarray(embeds), route, table, lengths, 32,
        chunk=chunk)
    ticks = []
    with torch.no_grad():
        logits, cache = tgen.prefill_chunked(
            tparams, tcfg, torch.from_numpy(embeds), route, table, lengths,
            32, chunk=chunk, tick_cb=lambda: ticks.append(1))
        seg = torch.as_tensor((np.arange(16)[None] < lengths[:, None])
                              .astype(np.int32))
        one_logits, one_cache = tgen._prefill(
            tparams, tcfg, torch.from_numpy(embeds),
            None if route is None else torch.from_numpy(route), table, seg,
            torch.from_numpy(lengths), 32)
    assert len(ticks) == -(-16 // chunk)  # one tick per chunk, tail included
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), one_logits.numpy(),
                               rtol=TOL, atol=TOL)
    want_rows = _valid_rows(want_cache, Lv)
    for part, rows in _torch_rows(cache, Lv).items():
        np.testing.assert_allclose(rows, want_rows[part], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            rows, _torch_rows(one_cache, Lv)[part], rtol=TOL, atol=TOL)


def _greedy(params, cfg, cache, logits, lengths, table, steps):
    """The port's greedy continuation from a prefilled cache."""
    out, kv = [], torch.as_tensor(lengths, dtype=torch.int32)
    with torch.no_grad():
        for _ in range(steps):
            tok = logits.argmax(-1)
            out.append(tok)
            logits, cache, kv = tgen._decode_step(params, cfg, cache, tok, kv,
                                                  table)
    return torch.stack(out, 1).tolist()


def test_prefill_chunked_kv_quant_matches_jax(chunk_setup):
    """kv_quant=True quantizes each chunk at append time: the int8 rows lie
    within one step of the JAX ones for over 99% of entries, and the greedy
    continuation through the int8 decode is bit-exact over 6 steps."""
    cfg, params, tcfg, tparams, embeds, route, lengths = chunk_setup
    table = cfg.routing_table()
    Lv = int(lengths[0])
    want_logits, want_cache = jgen.prefill_chunked(
        params, cfg, jnp.asarray(embeds), route, table, lengths, 32,
        chunk=4, kv_quant=True)
    with torch.no_grad():
        logits, cache = tgen.prefill_chunked(
            tparams, tcfg, torch.from_numpy(embeds), route, table, lengths,
            32, chunk=4, kv_quant=True)
    assert cache.k["q"].dtype == torch.int8
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    for part in ("k", "v"):
        got = getattr(cache, part)["q"][:, :, :Lv].numpy().astype(np.int32)
        want = np.asarray(getattr(want_cache, part)["q"])[:, :, :Lv]
        diff = np.abs(got - want.astype(np.int32))
        assert (diff <= 1).mean() > 0.99, (diff.max(), (diff <= 1).mean())
    want_ids, _ = jgen._decode_loop(
        params, cfg, want_cache, want_logits, jnp.asarray(lengths),
        jnp.asarray(table), jax.random.PRNGKey(0), 6, -1, do_sample=False)
    got_ids = _greedy(tparams, tcfg, cache, logits, lengths,
                      torch.as_tensor(table), 6)
    assert got_ids == np.asarray(want_ids).tolist()


def test_chunked_prefill_rejects_a_batch(chunk_setup):
    _, _, tcfg, tparams, embeds, _, lengths = chunk_setup
    two = torch.from_numpy(np.concatenate([embeds, embeds]))
    with pytest.raises(ValueError, match="batch 1"):
        tgen.prefill_chunked(tparams, tcfg, two, None, None, lengths, 32)


# ------------------------------------------------------------ SlotDecoder

@pytest.fixture(scope="module")
def pair():
    """A tiny vision model in both packages (eos -1: a random model has no
    natural EOS), the port's converted from the JAX one."""
    cfg = jax_tiny_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                          mm_projector_type="mlp2x_gelu", eos_token_id=-1)
    jm = JaxLM.random_init(cfg, jax.random.PRNGKey(0))
    return jm, model_from_jax(_numpy_model(jm), device="cpu")


def _pixels(seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (1, 28, 28, 3)).astype(np.float32)


def _schedule(dec, chunk):
    """admit slot 0 (image, one-shot), 3 ticks; admit slot 1 (text) chunked
    with a tick between chunks; 2 ticks; release slot 0, 2 ticks; readmit
    slot 0 (text) chunked, 3 ticks.  Greedy tokens from the host logits.
    Returns each tick's (tokens, kv_lens, active rows' logits)."""
    record = []

    def tick():
        logits = dec.host_logits()
        tokens = np.where(dec.active, logits.argmax(-1), 0).astype(np.int32)
        record.append((tokens.tolist(), np.asarray(dec.kv_lens).tolist(),
                       logits[np.asarray(dec.active)]))
        dec.step(tokens)

    dec.admit(0, np.array([1, IMG, 7, 8]), {"vision": _pixels()})
    for _ in range(3):
        tick()
    dec.prefill_chunk = chunk
    dec.admit(1, np.array([1, 11, 12, 13, 14, 15]), {}, tick_cb=tick)
    for _ in range(2):
        tick()
    dec.release(0)
    for _ in range(2):
        tick()
    assert dec.kv_lens[0] == 1 and dec.kv_lens[2] == 1  # idle rows pinned
    dec.admit(0, np.array([1, 40, 41]), {}, tick_cb=tick)
    for _ in range(3):
        tick()
    return record


@pytest.mark.parametrize("kv_quant", [False, True])
def test_slot_decoder_schedule_matches_jax(pair, kv_quant):
    """The fixed schedule in both packages: greedy ids and kv_lens equal at
    every tick, logits of the active rows within 1e-5; the unquantized pool
    is the config's dtype (fp32 here), the other int8."""
    jm, tm = pair
    want = _schedule(jslot.SlotDecoder(jm, max_slots=3, cache_len=64,
                                       kv_quant=kv_quant), chunk=16)
    got = _schedule(tslot.SlotDecoder(tm, max_slots=3, cache_len=64,
                                      kv_quant=kv_quant, device="cpu"),
                    chunk=16)
    assert len(got) == len(want) == 3 + 4 + 2 + 2 + 4 + 3
    for (t, kv, lg), (wt, wkv, wlg) in zip(got, want):
        assert t == wt and kv == wkv
        np.testing.assert_allclose(lg, wlg, rtol=1e-5, atol=1e-5)


def _cache(quantized, seed, batch=1):
    cfg = tiny_test_config()
    shape = (cfg.num_hidden_layers, batch, 8, cfg.num_key_value_heads,
             cfg.head_dim)
    gen = torch.Generator().manual_seed(seed)
    k, v = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    if quantized:
        k, v = quantize_kv(k), quantize_kv(v)
    return KVCache(k=k, v=v)


@pytest.mark.parametrize("pool_int8,small_int8", [
    (False, False), (True, True), (True, False)])
def test_splice_slot_writes_one_row_in_place(pool_int8, small_int8):
    """The splice copies the batch-1 cache into its row of the pool's own
    tensors, quantizing a float cache going into an int8 pool, and leaves
    the other rows untouched."""
    big, small = _cache(pool_int8, 0, batch=3), _cache(small_int8, 1)
    before = {p: {n: t.clone() for n, t in (c.items() if isinstance(c, dict)
                                            else [(None, c)])}
              for p, c in (("k", big.k), ("v", big.v))}
    ptrs = [t.data_ptr() for c in (big.k, big.v)
            for t in (c.values() if isinstance(c, dict) else [c])]
    out = big.splice(small, 1)
    assert out is big and ptrs == [t.data_ptr() for c in (big.k, big.v) for t
                                   in (c.values() if isinstance(c, dict)
                                       else [c])]
    for part in ("k", "v"):
        dst, src = getattr(big, part), getattr(small, part)
        if pool_int8 and not small_int8:
            src = quantize_kv(src)
        for n, t in (dst.items() if isinstance(dst, dict) else [(None, dst)]):
            s = src[n] if n else src
            assert torch.equal(t[:, 1], s[:, 0])
            for row in (0, 2):
                assert torch.equal(t[:, row], before[part][n][:, row])


def test_slot_decoder_refuses_another_device(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="slot pool"):
        tslot.SlotDecoder(tm, max_slots=2, cache_len=16, device="meta")


# ------------------------------------------------ ContinuousBatchingEngine

def _drain(events, timeout=60.0):
    toks = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            kind, payload = events.get(timeout=1.0)
        except Exception:
            continue
        if kind == "error":
            raise payload
        if kind == "done":
            return toks
        toks.append(payload)
    raise TimeoutError(f"stream incomplete: {toks}")


def _prepare(r):
    return r["ids"], r.get("modal_inputs", {}), r["max_new"], 0.0


@pytest.fixture
def engine_of(pair):
    """engine_of(**kw): a port engine on the pair's model, stopped after
    the test whatever happens."""
    engines = []

    def make(**kw):
        engines.append(tslot.ContinuousBatchingEngine(
            pair[1], kw.pop("prepare", _prepare), device="cpu", **kw))
        return engines[-1]
    yield make
    for e in engines:
        e.stop()


@pytest.mark.parametrize("chunk", [None, 16])
def test_staggered_requests_match_solo_greedy(pair, engine_of, chunk):
    """Request 2 arrives while request 1 decodes (chunked admission or
    one-shot); both emit the tokens of a solo greedy ``generate``."""
    _, tm = pair
    r1 = np.array([1, IMG, 7, 8])
    r2 = np.array([1, 11, 12, 13, 14])
    solo1 = tm.generate([r1], {"vision": _pixels()}, max_new_tokens=10)[0]
    solo2 = tm.generate([r2], {}, max_new_tokens=5)[0]
    engine = engine_of(max_slots=4, cache_len=64, prefill_chunk=chunk)
    ev1 = engine.submit({"ids": r1, "modal_inputs": {"vision": _pixels()},
                         "max_new": 10})
    kind, first = ev1.get(timeout=60)  # request 1 is decoding
    assert kind == "token"
    ev2 = engine.submit({"ids": r2, "max_new": 5})
    assert [first] + _drain(ev1) == solo1
    assert _drain(ev2) == solo2


def test_cancellation_frees_slot_and_budget_clamps(engine_of):
    engine = engine_of(max_slots=2, cache_len=256)
    cancel = threading.Event()
    ev = engine.submit({"ids": np.array([1, 5, 6]), "max_new": 200,
                        "_cancel": cancel})
    kind, _ = ev.get(timeout=60)
    assert kind == "token"
    cancel.set()
    assert len(_drain(ev, timeout=30)) < 100  # ends well before 200
    assert len(_drain(engine.submit({"ids": np.array([1, 9, 9]),
                                     "max_new": 3}))) == 3  # slot reusable
    # an oversize budget is clamped to the slot's remaining context
    toks = _drain(engine.submit({"ids": np.array([1, 5, 6]),
                                 "max_new": 500}), timeout=120)
    assert len(toks) == 256 - 3


def test_prompt_exceeding_slot_cache_errors(engine_of):
    engine = engine_of(max_slots=2, cache_len=16)
    ev = engine.submit({"ids": np.arange(1, 40), "max_new": 4})
    kind, payload = ev.get(timeout=60)
    assert kind == "error" and "slot cache" in str(payload)


def test_requests_beyond_slot_capacity_queue_and_complete(engine_of):
    engine = engine_of(max_slots=1, cache_len=64)
    evs = [engine.submit({"ids": np.array([1, 5 + i, 6]), "max_new": 4})
           for i in range(3)]
    assert [len(_drain(ev, timeout=120)) for ev in evs] == [4, 4, 4]


def test_int8_pool_chunked_matches_one_shot(engine_of):
    reqs = [np.array([1, 11, 12, 13, 14, 15, 16, 17]),
            np.array([1, 40, 41, 42])]
    outs = {}
    for chunk in (None, 4):
        engine = engine_of(max_slots=2, cache_len=64, kv_quant=True,
                           prefill_chunk=chunk)
        evs = [engine.submit({"ids": ids, "max_new": 6}) for ids in reqs]
        outs[chunk] = [_drain(ev, timeout=120) for ev in evs]
        assert all(len(o) == 6 for o in outs[chunk])
    assert outs[4] == outs[None]


def test_idle_slot_kv_len_stays_pinned(engine_of):
    engine = engine_of(max_slots=2, cache_len=64)
    ev_short = engine.submit({"ids": np.array([1, 5, 6]), "max_new": 2})
    ev_long = engine.submit({"ids": np.array([1, 7, 8]), "max_new": 30})
    _drain(ev_short, timeout=120)
    assert len(_drain(ev_long, timeout=120)) == 30
    dec = engine.decoder
    idle = [s for s in range(dec.max_slots) if not dec.active[s]]
    assert idle and all(dec.kv_lens[s] == 1 for s in idle)


def test_stop_errors_queued_and_post_stop_requests(engine_of):
    """stop() ends every consumer: the admitted slot, the requests queued
    behind it and a submit after stop."""
    engine = engine_of(max_slots=1, cache_len=64)
    ids = np.array([1, 11, 12])
    evs = [engine.submit({"ids": ids, "max_new": 400}) for _ in range(3)]
    assert evs[0].get(timeout=60)[0] == "token"  # admitted and decoding
    engine.stop()
    late = engine.submit({"ids": ids, "max_new": 4})
    for ev in evs + [late]:
        deadline, terminal = time.time() + 30.0, None
        while time.time() < deadline and terminal is None:
            try:
                kind, _ = ev.get(timeout=1.0)
            except Exception:
                continue
            if kind in ("error", "done"):
                terminal = kind
        assert terminal == "error", "a consumer would hang after stop()"
    engine.stop()  # idempotent


def test_scheduler_thread_runs_in_inference_mode(engine_of):
    """Grad mode is per thread: the scheduler enters inference mode itself,
    so the pool it writes never records autograd history."""
    seen = []

    def prepare(r):
        seen.append(torch.is_inference_mode_enabled())
        return _prepare(r)
    engine = engine_of(max_slots=1, cache_len=64, prepare=prepare)
    assert len(_drain(engine.submit({"ids": np.array([1, 5]),
                                     "max_new": 2}))) == 2
    assert seen == [True] and engine.decoder.cache.k.is_inference()


def test_sampled_slots_draw_from_the_seeded_generator(pair, engine_of):
    """Sampled slots draw on the device from the engine's
    ``torch.Generator``: the same ``rng_seed`` gives the same tokens, and a
    nucleus of one token (top-p 1e-6) gives the greedy answer at any
    temperature."""
    _, tm = pair
    ids = np.array([1, 21, 22, 23])
    greedy = tm.generate([ids], {}, max_new_tokens=8)[0]

    def run(seed, top_p):
        engine = engine_of(max_slots=2, cache_len=64, rng_seed=seed,
                           prepare=lambda r: (r["ids"], {}, 8, 1.5,
                                              r["top_p"]))
        return _drain(engine.submit({"ids": ids, "top_p": top_p}),
                      timeout=120)
    assert run(5, 1.0) == run(5, 1.0)
    assert run(5, 1e-6) == greedy
