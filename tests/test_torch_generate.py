"""The PyTorch port's packing and greedy generation against the JAX package.

Both packages run the same tiny vision model (a ``test:`` CLIP tower, the
JAX weights converted by ``modelcompose_tpu_torch.convert``) on the same
pixels.  Integer outputs (pack plans, greedy ids) must be identical.  The
tiny config runs in fp32 on the CPU, where the two packages differ only in
summation order (~1e-6 relative), far below the logit gaps of a greedy
choice.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.core import generate as jax_generate
from modelcompose_tpu.core import packing as jax_packing
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.core import packing

IMG = MODAL_TOKEN_INDEXES["vision"]
AUD = MODAL_TOKEN_INDEXES["audio"]
STEPS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers side by side: keep torch to one thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_model(jm):
    """The JAX model's trees with numpy leaves (what convert takes)."""
    def np_tree(t):
        return jax.tree.map(np.asarray, t)
    encoders = {m: types.SimpleNamespace(spec=e.spec, params=np_tree(e.params))
                for m, e in jm.encoders.items()}
    return types.SimpleNamespace(cfg=jm.cfg, params=np_tree(jm.params),
                                 projectors=np_tree(jm.projectors),
                                 encoders=encoders)


def _perturb(jm, seed):
    """Nonzero LoRA B and soft tokens, so routing changes the answer."""
    rng = np.random.default_rng(seed)
    layers = jm.params["layers"]
    for grp in ("attn", "mlp"):
        for p in layers[grp].values():
            p["lora_b"] = jnp.asarray(
                rng.normal(0, 0.05, p["lora_b"].shape), p["lora_b"].dtype)
    for key in ("prefix_tokens", "suffix_tokens"):
        for m, t in jm.params.get(key, {}).items():
            jm.params[key][m] = jnp.asarray(rng.normal(0, 0.5, t.shape),
                                            t.dtype)
    return jm


def _pair(seed, **overrides):
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           local_prefix_tokens=2, local_suffix_tokens=2,
                           **overrides)
    jm = _perturb(JaxLM.random_init(cfg, jax.random.PRNGKey(seed)), seed)
    return jm, model_from_jax(_numpy_model(jm), device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(1)  # seed 1: no row meets EOS within STEPS


def _batch(seed=3):
    pixels = np.random.default_rng(seed).normal(
        0, 1, (2, 28, 28, 3)).astype(np.float32)
    ids = [np.array([1, 5, IMG, 9, 10, 11]), np.array([1, IMG, 7])]
    return ids, {"vision": pixels}


def test_prepare_batch_matches_jax(pair):
    jm, tm = pair
    ids, inputs = _batch()
    j_emb, j_plan = jm.prepare_batch(ids, inputs, bucket_len=32)
    t_emb, t_plan = tm.prepare_batch(ids, inputs, bucket_len=32)
    for f in ("token_ids", "feat_idx", "is_feat", "route_ids", "segment_ids",
              "lengths"):
        np.testing.assert_array_equal(getattr(t_plan, f), getattr(j_plan, f))
    # fp32 tower + projector: summation order only
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fold_decode,kv_quant", [
    (False, False), (False, True), ("dense", False), ("dense", True)])
def test_greedy_ids_match_jax(pair, fold_decode, kv_quant):
    jm, tm = pair
    ids, inputs = _batch()
    embeds, plan = jm.prepare_batch(ids, inputs, bucket_len=32)
    want = jax_generate.generate(
        jm.params, jm.cfg, embeds, lengths=plan.lengths,
        route_ids=plan.route_ids, routing_table=jm.routing_table,
        segment_ids=plan.segment_ids, max_new_tokens=STEPS,
        fold_decode=fold_decode, kv_quant=kv_quant)
    got = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32,
                      fold_decode=fold_decode, kv_quant=kv_quant)
    assert got == want
    assert max(len(r) for r in got) == STEPS


def test_eos_stops_rows_like_jax():
    """Seed 0 meets EOS after 8 and 1 tokens: both packages cut there."""
    jm, tm = _pair(0)
    ids, inputs = _batch()
    want = jm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
    got = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
    assert got == want
    assert sorted(len(r) for r in got) == [1, 8]


def test_routing_changes_the_answer(pair):
    """Guard for the parity tests above: the adapters are live, so a model
    whose vision adapter is dropped answers differently."""
    _, tm = pair
    ids, inputs = _batch()
    base = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
    tm.routing_table = tm.routing_table.copy()
    tm.routing_table[2] = 0.0
    try:
        off = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32)
    finally:
        tm.routing_table = tm.cfg.routing_table()
    assert off != base


def test_compact_adapters_greedy_ids_match_jax():
    """Online-merge composition: the 'default' column is unreachable, so
    compaction really drops a column on both sides."""
    jm, tm = _pair(1, reset_scaling_weights="default-vision=1.0")
    ids, inputs = _batch(4)
    want = jm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32,
                       compact_adapters=True)
    got = tm.generate(ids, inputs, max_new_tokens=STEPS, bucket_len=32,
                      compact_adapters=True)
    assert got == want
    assert list(tm._compact_cache) == [(1, 2)]


@pytest.mark.parametrize("case", ["image", "counter", "mask", "text_only",
                                  "bucket"])
def test_plan_pack_matches_jax(case):
    spans = {"vision": (3, 4)}
    labels, masks, bucket_len = None, None, None
    if case == "image":
        ids = [np.array([1, 5, IMG, 9]), np.array([1, IMG, IMG, 7])]
        labels = [np.array([-100, 5, -100, 9]), np.array([-100, -100, -100, 7])]
        bucket_len = 16
    elif case == "counter":
        ids = [np.array([IMG, 4, AUD]), np.array([AUD, IMG, IMG])]
        spans = {"audio": (2, 3), "vision": (3, 4)}
        bucket_len = 24
    elif case == "mask":
        ids = [np.array([1, AUD, 3]), np.array([AUD])]
        spans = {"audio": (2, 3)}
        masks = {"audio": np.array([[1, 1, 0], [1, 0, 0]], bool)}
        bucket_len = 8
    elif case == "text_only":
        ids = [np.array([1, 2, 3]), np.array([1, IMG, IMG, IMG, 6])]
        bucket_len = 20
    else:  # bucket picked from the ladder
        ids = [np.arange(1, 600) % 50 + 1, np.array([1, IMG, IMG, IMG])]
    want = jax_packing.plan_pack(ids, spans, labels=labels, feat_masks=masks,
                                 bucket_len=bucket_len)
    got = packing.plan_pack(ids, spans, labels=labels, feat_masks=masks,
                            bucket_len=bucket_len)
    for f in ("token_ids", "feat_idx", "is_feat", "route_ids", "labels",
              "segment_ids", "lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.feat_layout == want.feat_layout
    assert packing.pick_bucket(600) == jax_packing.pick_bucket(600)
    assert packing.DEFAULT_BUCKETS == jax_packing.DEFAULT_BUCKETS


def test_assemble_embeds_matches_jax():
    rng = np.random.default_rng(5)
    ids = [np.array([1, 5, IMG, 9]), np.array([1, IMG, 7])]
    plan = packing.plan_pack(ids, {"vision": (2, 3)}, bucket_len=12)
    table = rng.normal(size=(16, 8)).astype(np.float32)
    feats = rng.normal(size=(2, 3, 8)).astype(np.float32)
    want = jax_packing.assemble_embeds(jnp.asarray(table), plan,
                                       {"vision": jnp.asarray(feats)})
    got = packing.assemble_embeds(torch.from_numpy(table), plan,
                                  {"vision": torch.from_numpy(feats)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_raises_not_implemented(pair):
    _, tm = pair
    ids, inputs = _batch()
    with pytest.raises(NotImplementedError, match="sampling"):
        tm.generate(ids, inputs, max_new_tokens=2, bucket_len=32,
                    temperature=0.7)
