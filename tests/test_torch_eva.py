"""The port's EVA-CLIP vision tower (``models/vision_eva``) against the JAX
package's, and the tower dispatch of both packages.

Both sides run the same weights (a JAX tree with every leaf randomized,
carried across by ``params_from_jax``) on the same seeded pixels, in both
tower families: EVA02-style (subln, SwiGLU, 2D rope) and EVA01-style
(GELU MLP, no rope).  Features are held to 1e-5 of their largest
magnitude in fp32 and 2e-2 in bf16; the rope tables (numpy) and the
converted trees are held to be identical.
"""

import dataclasses
import importlib
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.models import vision_eva as jeva

from modelcompose_tpu_torch.models import towers as ttowers
from modelcompose_tpu_torch.models import vision_eva as teva
from tests.test_torch_towers import (BF16_TOL, FP32_TOL, _assert_close,
                                     _assert_same_tree, _pair, _port,
                                     _randomize)

jtowers = importlib.import_module("modelcompose_tpu.models.towers")
J_EVA_TOWER = jeva.EvaVisionTower  # the dispatch test stubs the module's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family, **kw):
    """The ``eva-test:32x3`` tower's config (EVA02 family: the default
    preset) at 56 px, so the rope runs over a 4 x 4 grid; ``eva01`` turns
    off rope, SwiGLU and subln."""
    mcfg = tiny_test_config(mm_vision_encoder="eva-test:32x3")
    cfg = teva.EvaVisionTower("eva-test:32x3", _port(mcfg), params={}).cfg
    cfg = dataclasses.replace(cfg, image_size=56, **kw)
    if family == "eva01":
        cfg = dataclasses.replace(cfg, use_rope=False, swiglu=False,
                                  subln=False)
    return cfg


def _features(cfg, dtype, seed=1):
    jcfg = jeva.EvaVisionConfig(**dataclasses.asdict(cfg))
    tree = _randomize(jeva.init_eva_vision(jcfg, jax.random.PRNGKey(0)),
                      seed)
    jp, tp = _pair(tree, dtype)
    pixels = np.random.default_rng(seed + 1).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    want = jeva.eva_vision_features(jp, jcfg, jnp.asarray(pixels))
    got = teva.eva_vision_features(tp, cfg, torch.from_numpy(pixels))
    return got, want


@pytest.mark.parametrize("family", ["eva02", "eva01"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eva_features_match_jax(family, dtype):
    cfg = _cfg(family)
    got, want = _features(cfg, dtype)
    assert got.dtype == dtype and got.shape == (2, 16, 32)
    _assert_close(got, want, FP32_TOL if dtype == torch.float32
                  else BF16_TOL)


@pytest.mark.parametrize("select_layer", [0, -1, -2])
@pytest.mark.parametrize("select_feature", ["patch", "cls_patch"])
def test_eva_select_layer_and_feature_match_jax(select_layer,
                                                select_feature):
    cfg = _cfg("eva02", select_layer=select_layer,
               select_feature=select_feature)
    got, want = _features(cfg, torch.float32, seed=3)
    assert got.shape[1] == 16 + (select_feature != "patch")
    _assert_close(got, want, FP32_TOL)


def test_eva_runs_only_the_layers_up_to_the_tap():
    """select_layer -2 of 3 blocks runs 2: the third block's weights do
    not touch the output."""
    cfg = _cfg("eva02")
    tree = _randomize(jeva.init_eva_vision(
        jeva.EvaVisionConfig(**dataclasses.asdict(cfg)),
        jax.random.PRNGKey(0)), 5)
    _, tp = _pair(tree, torch.float32)
    pixels = torch.randn(1, 56, 56, 3, generator=torch.Generator()
                         .manual_seed(0))
    before = teva.eva_vision_features(tp, cfg, pixels)
    for p in tp["layers"]["w3"].values():
        p[2] = 7.0
    assert torch.equal(teva.eva_vision_features(tp, cfg, pixels), before)


@pytest.mark.parametrize("preset", sorted(jeva.PRESETS))
def test_rope_tables_at_full_size_are_equal(preset):
    """Each released preset's rope tables (EVA02-L-336: a 24 x 24 grid
    interpolated onto 16 positions, head_dim 64) are the JAX ones, bit for
    bit."""
    cfg = teva.PRESETS[preset]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jeva.PRESETS[preset])
    cos, sin = teva.vision_rope_tables(cfg)
    jcos, jsin = jeva.vision_rope_tables(jeva.PRESETS[preset])
    assert cos.shape == (cfg.num_patches, cfg.head_dim)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))


def test_full_presets_have_the_released_widths():
    l336 = teva.PRESETS["EVA02-CLIP-L-14-336"]
    g14 = teva.PRESETS["EVA01-CLIP-g-14"]
    assert (l336.ffn_hidden, l336.head_dim, l336.num_patches) == (2730, 64,
                                                                  576)
    assert (g14.ffn_hidden, g14.head_dim, g14.num_patches) == (6144, 88, 256)
    assert teva.PRESETS["EVA01-CLIP-g-14-336"].num_patches == 576


def test_interleaved_rotation_is_not_the_half_split():
    x = torch.arange(8.0)
    assert teva._rotate_half_interleaved(x).tolist() == [
        -1, 0, -3, 2, -5, 4, -7, 6]
    np.testing.assert_array_equal(
        teva._rotate_half_interleaved(x).numpy(),
        np.asarray(jeva._rotate_half_interleaved(jnp.arange(8.0))))


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------

def _eva_state(cfg, rng, fused, prefix=""):
    """An EVA ViT state dict in the released torch layout: separate q/k/v
    projections (EVA02) or a fused ``qkv`` (EVA01), q and v biases."""
    H, Fd, P, L = cfg.hidden_size, cfg.ffn_hidden, cfg.patch_size, cfg.depth
    sd = {"cls_token": (1, 1, H), "pos_embed": (1, cfg.num_patches + 1, H),
          "patch_embed.proj.weight": (H, 3, P, P),
          "patch_embed.proj.bias": (H,)}
    for i in range(L):
        b = f"blocks.{i}."
        for ln in ["norm1", "norm2"] + (
                ["attn.inner_attn_ln"] if cfg.subln else []):
            sd[b + ln + ".weight"] = sd[b + ln + ".bias"] = (H,)
        if fused:
            sd[b + "attn.qkv.weight"] = (3 * H, H)
        else:
            for n in "qkv":
                sd[b + f"attn.{n}_proj.weight"] = (H, H)
        sd[b + "attn.q_bias"] = sd[b + "attn.v_bias"] = (H,)
        sd[b + "attn.proj.weight"], sd[b + "attn.proj.bias"] = (H, H), (H,)
        mlp = ({"w1": (Fd, H), "w2": (Fd, H), "w3": (H, Fd)} if cfg.swiglu
               else {"fc1": (Fd, H), "fc2": (H, Fd)})
        for n, shape in mlp.items():
            sd[b + f"mlp.{n}.weight"], sd[b + f"mlp.{n}.bias"] = \
                shape, shape[:1]
        if cfg.subln:
            sd[b + "mlp.ffn_ln.weight"] = sd[b + "mlp.ffn_ln.bias"] = (Fd,)
    return {prefix + k: rng.normal(size=s).astype(np.float32)
            for k, s in sd.items()}


@pytest.mark.parametrize("family,fused,prefix", [
    ("eva02", False, ""), ("eva02", False, "visual."),
    ("eva01", True, ""), ("eva01", True, "visual.")])
def test_convert_eva_vision_matches_jax(family, fused, prefix):
    cfg = _cfg(family)
    state = _eva_state(cfg, np.random.default_rng(0), fused, prefix)
    want = jeva.convert_eva_vision(state, jeva.EvaVisionConfig(
        **dataclasses.asdict(cfg)))
    _assert_same_tree(teva.convert_eva_vision(state, cfg), want)


def test_eva_tower_loads_a_checkpoint_file(tmp_path):
    """``load_model`` reads a ``.pt`` torch pickle through the port's
    ``load_state`` and converts it as the JAX tower does."""
    cfg = _cfg("eva01")
    state = _eva_state(cfg, np.random.default_rng(1), fused=True)
    path = str(tmp_path / "EVA01_CLIP_g_14_psz14.pt")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    tower = teva.EvaVisionTower("eva-test:32x3", _port(tiny_test_config()),
                                params={})
    tower.cfg, tower.spec = cfg, path
    want = jeva.convert_eva_vision(state, jeva.EvaVisionConfig(
        **dataclasses.asdict(cfg)))
    _assert_same_tree(tower.load_model(device="cpu"), want)


# ---------------------------------------------------------------------------
# Dispatch (both towers of this slice and the earlier ones)
# ---------------------------------------------------------------------------

DISPATCH_SPECS = [
    ("vision", "eva-vit-g"), ("vision", "EVA01-CLIP-g-14"),
    ("vision", "EVA01-CLIP-g-14-336"), ("vision", "eva_clip_g"),
    ("vision", "EVA02_CLIP_L_336_psz14_s6B.pt"),
    ("vision", "/ckpts/EVA02-CLIP-L-14-336/open_clip_pytorch_model.bin"),
    ("vision", "eva-test:32x2"), ("vision", "openai/clip-vit-large-patch14-336"),
    ("audio", "VideoLLaMA/imagebind_huge"), ("audio", "imagebind_huge"),
    ("audio", "ImageBind/imagebind_huge.pth"),
    ("audio", "imagebind-test:16x2"), ("audio", "BEATs_iter3_plus_AS2M.pt"),
    ("audio", "test:16x2"), ("video", "LanguageBind_Video_merge"),
    ("point", "point_bert_v1.2.pt")]


def _jax_tower_picked(modal, spec, monkeypatch):
    """The class name the JAX ``build_modal_encoders`` builds for ``spec``,
    with every tower class stubbed to record its arguments instead."""
    picked = {}

    def stub(name):
        def build(spec, cfg, rng=None, **kw):
            picked.update(name=name, spec=spec)
            return types.SimpleNamespace()
        return build
    for module, name in [("vision_eva", "EvaVisionTower"),
                         ("audio_imagebind", "ImageBindAudioTower"),
                         ("audio_beats", "BeatsAudioTower"),
                         ("video_languagebind", "LanguageBindVideoTower"),
                         ("point_bert", "PointBertTower")]:
        monkeypatch.setattr(
            importlib.import_module(f"modelcompose_tpu.models.{module}"),
            name, stub(name))
    monkeypatch.setattr(jtowers, "ClipVisionTower", stub("ClipVisionTower"))
    cfg = tiny_test_config(**{f"mm_{modal}_encoder": spec})
    with warnings.catch_warnings():  # random tower weights: not built here
        warnings.simplefilter("ignore")
        jtowers.build_modal_encoders(cfg)
    return picked["name"], cfg


@pytest.mark.parametrize("modal,spec", DISPATCH_SPECS)
def test_tower_class_matches_jax_dispatch(modal, spec, monkeypatch):
    name, cfg = _jax_tower_picked(modal, spec, monkeypatch)
    cls = ttowers.tower_class(modal, spec)
    assert cls.__name__ == name
    if cls is teva.EvaVisionTower:  # and the preset each spec picks
        want = J_EVA_TOWER._preset_for(spec)
        got = cls(spec, _port(cfg), params={}).cfg
        assert dataclasses.asdict(got) == dataclasses.asdict(
            dataclasses.replace(
                want, **({} if not spec.startswith("eva-test:") else dict(
                    hidden_size=32, depth=2, num_heads=2, image_size=28,
                    patch_size=14, mlp_ratio=2.0, pt_hw_seq_len=2)),
                select_layer=cfg.mm_vision_select_layer,
                select_feature=cfg.mm_vision_select_feature))


@pytest.mark.parametrize("spec,preset", [
    ("eva-vit-g", "EVA02-CLIP-L-14-336"),
    ("EVA01-CLIP-g-14", "EVA01-CLIP-g-14"),
    ("EVA01-CLIP-g-14-336", "EVA01-CLIP-g-14-336"),
    ("eva_clip_g", "EVA01-CLIP-g-14"),
    ("EVA02_CLIP_L_336_psz14_s6B.pt", "EVA02-CLIP-L-14-336")])
def test_preset_rule_is_the_jax_rule(spec, preset):
    """``eva-vit-g`` falls to the EVA02-L default in both packages (the JAX
    rule, kept as it is)."""
    assert teva.EvaVisionTower._preset_for(spec) == teva.PRESETS[preset]
    assert dataclasses.asdict(jeva.EvaVisionTower._preset_for(spec)) \
        == dataclasses.asdict(teva.PRESETS[preset])


def test_eva_tower_encode_and_protocol():
    cfg = tiny_test_config(mm_vision_encoder="eva-test:32x2",
                           mm_hidden_size=32)
    tower = teva.EvaVisionTower("eva-test:32x2", _port(cfg), device="cpu")
    assert (tower.hidden_size, tower.feature_len) == (32, 4)
    out = tower.encode(np.zeros((3, 28, 28, 3), np.float32))
    assert out.shape == (3, 4, 32) and out.dtype == torch.float32
    assert tower.modal_processor.size == 28
