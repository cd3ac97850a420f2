"""The port's beam search, beam sampling and the ``concat`` decode fold
against the JAX package.

Both packages run the same tiny vision + audio model (the JAX weights moved
by ``modelcompose_tpu_torch.convert``) in fp32 on the CPU, where they differ
only in summation order (~1e-6 relative), far below the score gaps the
scorer ranks.  Token ids must be identical.  Beam sampling draws from
different RNGs in the two frameworks, so its bookkeeping is held to the
JAX package's through the ``_draw_override`` hook (the same drawn flat
candidates on both sides); in the tight-nucleus case every finite
candidate is drawn whatever the RNG, as long as the fp32 filter can tell
the candidates apart.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.core import beam as jbeam
from modelcompose_tpu.core import generate as jgenerate

from modelcompose_tpu_torch.config import tiny_test_config
from modelcompose_tpu_torch.convert import params_from_jax
from modelcompose_tpu_torch.core import beam, generate
from modelcompose_tpu_torch.core.llama import KVCache
from modelcompose_tpu_torch.ops import routed_lora
from tests.test_torch_generate import AUD, IMG, _pair

jrl = importlib.import_module("modelcompose_tpu.ops.routed_lora")
STEPS = 8
AUDIO = dict(mm_audio_encoder="test:16x2", mm_audio_hidden_size=16,
             reset_scaling_weights="default-vision=0.5,default-audio=0.25")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return _pair(2, **AUDIO)


def _prompts():
    """The cases of tests/test_beam_golden.py: image, audio + image, and
    text only."""
    rng = np.random.default_rng(7)
    vis = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    aud = {"audio_inputs": rng.normal(size=(1, 64, 8)).astype(np.float32),
           "audio_padding_mask": np.zeros((1, 64), bool)}
    return [(np.array([1, 5, IMG, 7, 8, 9]), {"vision": vis}),
            (np.array([1, AUD, 6, IMG, 10]), {"vision": vis, "audio": aud}),
            (np.array([1, 11, 12, 13, 14]), {})]


def _core_args(model, ids, inputs):
    embeds, plan = model.prepare_batch([ids], inputs)
    return embeds, dict(lengths=plan.lengths, route_ids=plan.route_ids,
                        routing_table=model.routing_table,
                        segment_ids=plan.segment_ids,
                        scoring_prompt_len=len(ids))


def _both(pair, ids, inputs, **kw):
    """beam_generate of each package on its own model's packed prompt."""
    jm, tm = pair
    j_emb, j_kw = _core_args(jm, ids, inputs)
    with torch.no_grad():
        t_emb, t_kw = _core_args(tm, ids, inputs)
        got = beam.beam_generate(tm.params, tm.cfg, t_emb, **t_kw, **kw)
    want = jbeam.beam_generate(jm.params, jm.cfg, j_emb, **j_kw, **kw)
    return got, want


@pytest.mark.parametrize("num_beams", [2, 3])
def test_beam_ids_match_jax(pair, num_beams):
    jm, tm = pair
    differs_from_greedy = False
    for ids, inputs in _prompts():
        want = jm.generate([ids], inputs, max_new_tokens=STEPS,
                           num_beams=num_beams)
        got = tm.generate([ids], inputs, max_new_tokens=STEPS,
                          num_beams=num_beams)
        assert got == want, (ids, got, want)
        assert len(got) == 1 and len(got[0]) == STEPS
        greedy = tm.generate([ids], inputs, max_new_tokens=STEPS)
        differs_from_greedy |= got != greedy
    # the cases must exercise beam search, not collapse to greedy
    assert differs_from_greedy


def test_beam_early_eos_matches_jax(pair):
    """EOS set to a token the beams meet: hypotheses finalize early, the
    same way on both sides."""
    ids, inputs = _prompts()[0]
    plain, _ = _both(pair, ids, inputs, num_beams=3, max_new_tokens=STEPS,
                     eos_token_id=-1)
    shorter = False
    for eos in plain[0][:3]:
        got, want = _both(pair, ids, inputs, num_beams=3,
                          max_new_tokens=STEPS, eos_token_id=eos)
        assert got == want, (eos, got, want)
        assert eos not in got[0]
        shorter |= len(got[0]) < STEPS
    assert shorter


@pytest.mark.parametrize("temperature,top_p", [(0.9, 0.9), (1.3, 1.0)])
def test_beam_sample_bookkeeping_matches_jax(pair, temperature, top_p):
    """The same drawn flat candidates on both sides: warping, the top-p
    filter, candidate order, scorer and cache reorder give the same ids."""
    _, tm = pair
    rng = np.random.default_rng(11)
    n_flat = 3 * tm.cfg.vocab_size
    draws = [rng.choice(n_flat, 6, replace=False) for _ in range(STEPS)]
    for ids, inputs in _prompts()[:2]:
        got, want = _both(pair, ids, inputs, num_beams=3,
                          max_new_tokens=STEPS, temperature=temperature,
                          top_p=top_p, _draw_override=draws)
        assert got == want, (ids, got, want)


@pytest.mark.parametrize("steps", [3, STEPS])
def test_beam_sample_tight_nucleus_matches_jax(pair, steps):
    """A sharp temperature and a tight top_p leave fewer than 2*num_beams
    finite candidates: every one is drawn, whatever the RNG, and the beams
    replicate the best instead of raising (4.31's multinomial would).

    4.31 divides the running scores by the temperature again every step,
    so by the fourth step at 0.01 they reach ~1e9, where the fp32 top-p
    filter ties whole rows and the draw depends on the RNG again: the ids
    are held to the JAX package's over three steps; over eight, both
    packages degrade the same way (valid tokens, the greedy first one)."""
    jm, tm = pair
    ids, inputs = _prompts()[0]
    kw = dict(num_beams=3, max_new_tokens=steps, temperature=0.01,
              top_p=0.05)
    j_emb, j_kw = _core_args(jm, ids, inputs)
    want = jbeam.beam_generate(jm.params, jm.cfg, j_emb, **j_kw,
                               rng=jax.random.PRNGKey(3), **kw)
    with torch.no_grad():
        t_emb, t_kw = _core_args(tm, ids, inputs)
        got = beam.beam_generate(tm.params, tm.cfg, t_emb, **t_kw,
                                 generator=torch.Generator().manual_seed(3),
                                 **kw)
    if steps == 3:
        assert got == want
    greedy = tm.generate([ids], inputs, max_new_tokens=1)[0][0]
    for out in (got[0], want[0]):
        assert 0 < len(out) <= steps
        assert all(0 <= t < tm.cfg.vocab_size for t in out)
        assert out[0] == greedy


def test_beam_sampling_follows_the_generator(pair):
    _, tm = pair
    ids, inputs = _prompts()[0]

    def run(seed):
        return tm.generate([ids], inputs, max_new_tokens=STEPS, num_beams=3,
                           temperature=1.5,
                           generator=torch.Generator().manual_seed(seed))
    assert run(0) == run(0)
    assert any(run(s) != run(0) for s in (1, 2, 3))


def test_gather_beams_in_place_matches_index_select():
    """The in-place gather over [start, stop) equals ``index_select`` of
    the whole cache where the rows before ``start`` agree across beams (one
    tiled prefill), for a bf16 and an int8 cache, and keeps the buffers."""
    rng = np.random.default_rng(0)
    for quantized in (False, True):
        cfg = tiny_test_config(dtype="bfloat16")
        one = KVCache.zeros(cfg, 1, 12, quantized=quantized)
        for t in one.tensors():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype))
        cache = beam._tile_beams(one, 3)
        for t in cache.tensors():  # rows past 5 differ per beam
            t[:, :, 5:] = torch.from_numpy(rng.normal(
                size=t[:, :, 5:].shape)).to(t.dtype)
        idx = torch.tensor([2, 0, 2])
        want = [t.index_select(1, idx) for t in cache.tensors()]
        ptrs = [t.data_ptr() for t in cache.tensors()]
        beam._gather_beams(cache, idx, 5, 9)
        for t, w, p in zip(cache.tensors(), want, ptrs):
            assert t.data_ptr() == p
            assert torch.equal(t[:, :, :9], w[:, :, :9])


@pytest.mark.parametrize("row", [[0.0, 0.0, 0.0, 0.5, 1.0],
                                 [0.0, 2.0, 0.0, 0.0, 0.0],
                                 [0.0] * 5, [0.3, 0.7, 0.333, 0.1, 2.0]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_decode_adapters_matches_jax(pair, row, dtype):
    jm, _ = pair
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype)
                           if jnp.issubdtype(a.dtype, jnp.floating) else a,
                           jm.params)
    default = np.asarray(row, np.float32)
    want, want_table = jrl.fold_decode_adapters(jparams, default)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    got, got_table = routed_lora.fold_decode_adapters(
        tparams, torch.from_numpy(default))
    np.testing.assert_array_equal(got_table.numpy(), np.asarray(want_table))
    for grp in ("attn", "mlp"):
        for name, p in want["layers"][grp].items():
            for leaf in ("lora_a", "lora_b"):
                g = got["layers"][grp][name][leaf]
                w = np.asarray(p[leaf], np.float32)
                assert g.shape == w.shape, (name, leaf)
                assert g.dtype == getattr(torch, dtype)
                np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-6,
                                           atol=1e-6, err_msg=name + leaf)
            assert got["layers"][grp][name]["w"] is \
                tparams["layers"][grp][name]["w"]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_concat_fold_greedy_ids_match_jax(pair, kv_quant):
    jm, tm = pair
    ids, inputs = _prompts()[1]
    batch = [ids, np.array([1, 5, IMG, 9])]
    inputs = dict(inputs, vision=np.concatenate([inputs["vision"]] * 2))
    embeds, plan = jm.prepare_batch(batch, inputs, bucket_len=64)
    kw = dict(lengths=plan.lengths, route_ids=plan.route_ids,
              routing_table=jm.routing_table, segment_ids=plan.segment_ids,
              max_new_tokens=16, fold_decode="concat", kv_quant=kv_quant)
    want = jgenerate.generate(jm.params, jm.cfg, embeds, **kw)
    with torch.no_grad():
        t_emb, _ = tm.prepare_batch(batch, inputs, bucket_len=64)
        got = generate.generate(tm.params, tm.cfg, t_emb, **kw)
        unfolded = generate.generate(tm.params, tm.cfg, t_emb,
                                     **dict(kw, fold_decode=False))
    assert got == want
    assert got == unfolded
