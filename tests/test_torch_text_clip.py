"""The port's CLIP text encoder (``models/text_clip``) against the JAX
package's: the same randomized weights on the same seeded ids, with and
without key padding, held to 1e-5 of the largest magnitude in fp32 and
2e-2 in bf16; the HF converter's trees identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.models import text_clip as jtext

from modelcompose_tpu_torch.models import text_clip as ttext
from tests.test_torch_towers import (BF16_TOL, FP32_TOL, _assert_close,
                                     _assert_same_tree, _pair)

CFG = ttext.ClipTextConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           vocab_size=100, max_position_embeddings=16,
                           projection_dim=24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg():
    return jtext.ClipTextConfig(**dataclasses.asdict(CFG))


def _randomized(seed=1):
    """The JAX tree with every leaf seeded: LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        scale = str(getattr(path[-1], "key", "")) == "scale"
        x = rng.normal(size=np.shape(a))
        return ((1 + 0.1 * x) if scale else 0.1 * x).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, jtext.init_clip_text(_jcfg(), jax.random.PRNGKey(0)))


def _ids(seed=2):
    """Three texts of 12, 9 and 5 tokens; each ends in EOT (the largest
    id, 99), followed by padding (id 0)."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((3, 12), np.int64)
    mask = np.zeros((3, 12), np.int64)
    for row, n in enumerate((12, 9, 5)):
        ids[row, :n - 1] = rng.integers(1, 98, n - 1)
        ids[row, n - 1] = 99
        mask[row, :n] = 1
    return ids, mask


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_text_matches_jax(padded, dtype):
    jp, tp = _pair(_randomized(), dtype)
    ids, mask = _ids()
    want = jtext.clip_text_embeds(jp, _jcfg(), jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(mask) if padded else None)
    got = ttext.clip_text_embeds(tp, CFG, torch.from_numpy(ids),
                                 torch.from_numpy(mask) if padded else None)
    assert got.shape == (3, 24) and got.dtype == dtype
    _assert_close(got, want, FP32_TOL if dtype == torch.float32
                  else BF16_TOL)


def test_padding_after_eot_does_not_change_the_embedding():
    """Causal attention: what follows EOT never reaches its row."""
    _, tp = _pair(_randomized(3), torch.float32)
    ids, mask = _ids(4)
    a = ttext.clip_text_embeds(tp, CFG, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    ids[1, 9:] = 7
    b = ttext.clip_text_embeds(tp, CFG, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _hf_state(rng):
    H, I, L = CFG.hidden_size, CFG.intermediate_size, CFG.num_hidden_layers
    sd = {"text_model.embeddings.token_embedding.weight": (CFG.vocab_size, H),
          "text_model.embeddings.position_embedding.weight":
              (CFG.max_position_embeddings, H),
          "text_model.final_layer_norm.weight": (H,),
          "text_model.final_layer_norm.bias": (H,),
          "text_projection.weight": (CFG.projection_dim, H)}
    for i in range(L):
        b = f"text_model.encoder.layers.{i}."
        for n, (o, n_in) in {"self_attn.q_proj": (H, H),
                             "self_attn.k_proj": (H, H),
                             "self_attn.v_proj": (H, H),
                             "self_attn.out_proj": (H, H),
                             "mlp.fc1": (I, H), "mlp.fc2": (H, I)}.items():
            sd[b + n + ".weight"], sd[b + n + ".bias"] = (o, n_in), (o,)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[b + ln + ".weight"] = sd[b + ln + ".bias"] = (H,)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def test_convert_hf_clip_text_matches_jax():
    state = _hf_state(np.random.default_rng(0))
    _assert_same_tree(ttext.convert_hf_clip_text(state, CFG),
                      jtext.convert_hf_clip_text(state, _jcfg()))


def test_encoder_protocol_matches_jax():
    tree = _randomized(5)
    jp, tp = _pair(tree, torch.float32)
    ids, mask = _ids(6)
    enc = ttext.ClipTextEncoder(CFG, params=tp)
    jenc = jtext.ClipTextEncoder(_jcfg(), params=jp)
    assert (enc.hidden_size, enc.feature_len) == (jenc.hidden_size,
                                                  jenc.feature_len) == (24, 1)
    got = enc.encode(ids, mask)
    assert got.shape == (3, 1, 24)
    _assert_close(got, jenc.encode(ids, mask), FP32_TOL)
    assert enc.modal_processor is None


def test_encoder_random_init_full_size_shapes():
    enc = ttext.ClipTextEncoder(device="cpu")
    assert enc.params["token_embedding"].shape == (49408, 768)
    assert enc.params["layers"]["fc1"]["w"].shape == (12, 768, 3072)
    assert enc.params["text_projection"].shape == (768, 768)
