"""The PyTorch port's BEATs, LanguageBind video and PointBERT towers, its
Q-Former projector and the towers' checkpoint converters, against the JAX
package.

Both sides run the same weights (the JAX tree carried across by
``modelcompose_tpu_torch.convert.params_from_jax``) on the same seeded
numpy inputs, at the tiny ``test:`` sizes.  Features are held to 1e-5 of
their largest magnitude in fp32 (summation order only) and to 2e-2 in bf16
(rounding of the activations between ops); farthest-point-sampling indices
and converted trees are held to be identical.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.models import audio_beats as jbeats
from modelcompose_tpu.models import point_bert as jpoint
from modelcompose_tpu.models import projectors as jproj
from modelcompose_tpu.models import video_languagebind as jvideo
from modelcompose_tpu.models.vision_clip import \
    convert_hf_clip_vision as j_convert_clip

from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax, params_to_numpy
from modelcompose_tpu_torch.models import audio_beats as tbeats
from modelcompose_tpu_torch.models import point_bert as tpoint
from modelcompose_tpu_torch.models import projectors as tproj
from modelcompose_tpu_torch.models import video_languagebind as tvideo
from modelcompose_tpu_torch.models.towers import (ClipVisionTower,
                                                  build_modal_encoders)
from modelcompose_tpu_torch.models.vision_clip import (ClipVisionConfig,
                                                       convert_hf_clip_vision)
from modelcompose_tpu_torch.tree import tree_leaves

FP32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _port(cfg):
    """The port's config from the JAX config's dict: each package gets
    its own config class."""
    return PortConfig.from_dict(cfg.to_dict())



def _randomize(tree, seed):
    """Every leaf of a JAX param tree replaced by seeded values of its shape
    (numpy fp32): LayerNorm scales near 1, BatchNorm variances positive,
    everything else N(0, 0.1), so no bias or statistic is trivially zero."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        shape = np.shape(a)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(tree_np, dtype):
    """(JAX tree, port tree) of ``dtype`` from one numpy tree."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree_np)
    return jtree, params_from_jax(jax.tree.map(np.asarray, jtree),
                                  dtype=dtype)


def _assert_close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max err {err:.3g} vs {tol} * {scale:.3g}"


def _assert_same_tree(got_torch, want_jax):
    got = dict(tree_leaves(params_to_numpy(got_torch)))
    want = dict(tree_leaves(jax.tree.map(np.asarray, want_jax)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        assert got[path].dtype == want[path].dtype, path


# ---------------------------------------------------------------------------
# BEATs
# ---------------------------------------------------------------------------

def _beats_cfg():
    return tbeats.BeatsAudioTower("test:16x2", device="cpu").cfg


@pytest.mark.parametrize("dtype,masked", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, True)])
def test_beats_matches_jax(dtype, masked):
    cfg = _beats_cfg()
    jcfg = jbeats.BeatsConfig(**dataclasses.asdict(cfg))
    tree = _randomize(jbeats.init_beats(jcfg, jax.random.PRNGKey(0)), 1)
    jp, tp = _pair(tree, dtype)
    rng = np.random.default_rng(2)
    fbank = rng.normal(size=(2, 64, cfg.fbank_bins)).astype(np.float32)
    mask = None
    if masked:  # row 1: its last 22 frames are padding
        mask = np.zeros((2, 64), bool)
        mask[1, 42:] = True
    want, want_pad = jbeats.beats_extract_features(
        jp, jcfg, jnp.asarray(fbank),
        None if mask is None else jnp.asarray(mask))
    got, got_pad = tbeats.beats_extract_features(
        tp, cfg, torch.from_numpy(fbank),
        None if mask is None else torch.from_numpy(mask))
    _assert_close(got, want, FP32_TOL if dtype == torch.float32 else BF16_TOL)
    if masked:
        np.testing.assert_array_equal(got_pad.numpy(), np.asarray(want_pad))
        assert got_pad[1].any() and not got_pad[0].any()
    else:
        assert got_pad is None and want_pad is None


def test_beats_tower_encode_returns_valid_mask():
    tower = tbeats.BeatsAudioTower("test:16x2", device="cpu")
    fbank = np.random.default_rng(0).normal(size=(1, 64, 8))
    mask = np.zeros((1, 64), bool)
    mask[0, 60:] = True
    feats, valid = tower.encode(fbank.astype(np.float32), mask)
    assert feats.shape == (1, 32, 16)
    assert valid.dtype == torch.bool and valid[0, :-2].all() \
        and not valid[0, -2:].any()


def test_beats_position_bias_full_size_matches_jax():
    """The 320-bucket, 800-distance bias at the recipe's 512 tokens: the
    int cast of the fp32 log picks the same bucket everywhere."""
    cfg = tbeats.BeatsConfig()
    table = np.random.default_rng(0).normal(
        size=(cfg.num_buckets, cfg.encoder_attention_heads)).astype(
            np.float32)
    want = jbeats.compute_position_bias(jnp.asarray(table), 512, 512,
                                        cfg.num_buckets, cfg.max_distance)
    got = tbeats.compute_position_bias(torch.from_numpy(table), 512, 512,
                                       cfg.num_buckets, cfg.max_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rel = np.arange(-2048, 2049)
    np.testing.assert_array_equal(
        tbeats.relative_position_bucket(torch.from_numpy(rel), 320,
                                        800).numpy(),
        np.asarray(jbeats.relative_position_bucket(jnp.asarray(rel), 320,
                                                   800)))


def _beats_state(cfg, rng):
    E, H, Fd, L = (cfg.embed_dim, cfg.encoder_embed_dim,
                   cfg.encoder_ffn_embed_dim, cfg.encoder_layers)
    nh, P, k = cfg.encoder_attention_heads, cfg.input_patch_size, \
        cfg.conv_pos
    sd = {"patch_embedding.weight": (E, 1, P, P),
          "layer_norm.weight": (E,), "layer_norm.bias": (E,),
          "post_extract_proj.weight": (H, E), "post_extract_proj.bias": (H,),
          "encoder.pos_conv.0.weight_g": (1, 1, k),
          "encoder.pos_conv.0.weight_v": (H, H // cfg.conv_pos_groups, k),
          "encoder.pos_conv.0.bias": (H,),
          "encoder.layer_norm.weight": (H,), "encoder.layer_norm.bias": (H,),
          "encoder.layers.0.self_attn.relative_attention_bias.weight":
              (cfg.num_buckets, nh)}
    for i in range(L):
        pre = f"encoder.layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (H, H),
                             "self_attn.k_proj": (H, H),
                             "self_attn.v_proj": (H, H),
                             "self_attn.out_proj": (H, H),
                             "self_attn.grep_linear": (8, H // nh),
                             "fc1": (Fd, H), "fc2": (H, Fd)}.items():
            sd[pre + name + ".weight"] = (o, n)
            sd[pre + name + ".bias"] = (o,)
        sd[pre + "self_attn.grep_a"] = (1, nh, 1, 1)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[pre + ln + ".weight"] = (H,)
            sd[pre + ln + ".bias"] = (H,)
    return {key: rng.normal(size=shape).astype(np.float32)
            for key, shape in sd.items()}


def test_convert_beats_checkpoint_matches_jax():
    cfg = _beats_cfg()
    state = _beats_state(cfg, np.random.default_rng(0))
    want = jbeats.convert_beats_checkpoint(
        state, jbeats.BeatsConfig(**dataclasses.asdict(cfg)))
    _assert_same_tree(tbeats.convert_beats_checkpoint(state, cfg), want)


def test_beats_tower_loads_a_pt_checkpoint(tmp_path):
    cfg = _beats_cfg()
    state = _beats_state(cfg, np.random.default_rng(1))
    path = str(tmp_path / "beats.pt")
    raw_cfg = {k: v for k, v in dataclasses.asdict(cfg).items()
               if k != "fbank_bins"}
    torch.save({"cfg": raw_cfg,
                "model": {k: torch.from_numpy(v) for k, v in state.items()}},
               path)
    jtower = jbeats.BeatsAudioTower(path)
    ttower = tbeats.BeatsAudioTower(path, device="cpu")
    assert dataclasses.asdict(ttower.cfg) == dataclasses.asdict(jtower.cfg)
    _assert_same_tree(ttower.params, jtower.params)


# ---------------------------------------------------------------------------
# LanguageBind video
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_languagebind_video_matches_jax(dtype):
    cfg = tvideo.LanguageBindVideoTower("test:32x3", device="cpu").cfg
    jcfg = jvideo.LanguageBindVideoConfig(**dataclasses.asdict(cfg))
    tree = _randomize(jvideo.init_languagebind_video(
        jcfg, jax.random.PRNGKey(0)), 3)
    jp, tp = _pair(tree, dtype)
    videos = np.random.default_rng(4).normal(size=(2, 2, 28, 28, 3)).astype(
        np.float32)
    want = jvideo.languagebind_video_features(jp, jcfg, jnp.asarray(videos))
    got = tvideo.languagebind_video_features(tp, cfg,
                                             torch.from_numpy(videos))
    assert got.shape == (2, 2, 5, 32)
    _assert_close(got, want, FP32_TOL if dtype == torch.float32 else BF16_TOL)


def _clip_layer_keys(pre, H, I, sd, temporal=False, T=0):
    for name, (o, n) in {"self_attn.q_proj": (H, H),
                         "self_attn.k_proj": (H, H),
                         "self_attn.v_proj": (H, H),
                         "self_attn.out_proj": (H, H),
                         "mlp.fc1": (I, H), "mlp.fc2": (H, I)}.items():
        sd[pre + name + ".weight"] = (o, n)
        sd[pre + name + ".bias"] = (o,)
    for ln in ("layer_norm1", "layer_norm2"):
        sd[pre + ln + ".weight"] = (H,)
        sd[pre + ln + ".bias"] = (H,)
    if temporal:
        sd[pre + "temporal_embedding"] = (1, T, H)
        sd[pre + "temporal_layer_norm1.weight"] = (H,)
        sd[pre + "temporal_layer_norm1.bias"] = (H,)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[pre + f"temporal_attn.{name}.weight"] = (H, H)
            sd[pre + f"temporal_attn.{name}.bias"] = (H,)


def _clip_state(cfg, rng, temporal=False):
    """An HF-layout CLIP (or, with ``temporal``, LanguageBind video) state
    dict for ``cfg``: every key its converter reads, random values."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    P = cfg.patch_size
    sd = {"embeddings.class_embedding": (H,),
          "embeddings.patch_embedding.weight": (H, 3, P, P),
          "embeddings.position_embedding.weight": (cfg.num_positions, H),
          "pre_layrnorm.weight": (H,), "pre_layrnorm.bias": (H,)}
    for i in range(cfg.num_hidden_layers):
        _clip_layer_keys(f"encoder.layers.{i}.", H, I, sd, temporal,
                         getattr(cfg, "num_frames", 0))
    return {f"vision_model.{k}": rng.normal(size=s).astype(np.float32)
            for k, s in sd.items()}


def test_convert_languagebind_video_matches_jax():
    cfg = tvideo.LanguageBindVideoTower("test:32x3", device="cpu").cfg
    state = _clip_state(cfg, np.random.default_rng(5), temporal=True)
    want = jvideo.convert_languagebind_video(
        state, jvideo.LanguageBindVideoConfig(**dataclasses.asdict(cfg)))
    _assert_same_tree(tvideo.convert_languagebind_video(state, cfg), want)


def test_clip_and_video_towers_load_hf_directories(tmp_path, monkeypatch):
    """A ``test:`` spec that is also a directory of the working directory
    loads its weights at the tiny size, on both sides."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_test_config(mm_vision_encoder="test:32x2",
                           mm_video_encoder="test:32x3")
    rng = np.random.default_rng(6)
    for spec, temporal, tower_cfg in (
            ("test:32x2", False,
             ClipVisionTower("test:32x2", _port(cfg), device="cpu").cfg),
            ("test:32x3", True,
             tvideo.LanguageBindVideoTower("test:32x3", _port(cfg),
                                          device="cpu").cfg)):
        (tmp_path / spec).mkdir()
        torch.save({k: torch.from_numpy(v) for k, v in
                    _clip_state(tower_cfg, rng, temporal).items()},
                   str(tmp_path / spec / "pytorch_model.bin"))
    from modelcompose_tpu.models.towers import \
        build_modal_encoders as j_build
    want = j_build(cfg)
    got = build_modal_encoders(_port(cfg), device="cpu")
    for modal in ("vision", "video"):
        _assert_same_tree(got[modal].params, want[modal].params)


def test_convert_hf_clip_vision_matches_jax():
    cfg = ClipVisionConfig(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=28, patch_size=14)
    state = _clip_state(cfg, np.random.default_rng(7))
    from modelcompose_tpu.models.vision_clip import ClipVisionConfig as JCfg
    want = j_convert_clip(state, JCfg(**dataclasses.asdict(cfg)))
    _assert_same_tree(convert_hf_clip_vision(state, cfg), want)


# ---------------------------------------------------------------------------
# PointBERT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,npoint", [((2, 300, 3), 40),
                                          ((1, 8192, 3), 512)])
def test_farthest_point_sample_is_bit_exact(shape, npoint):
    xyz = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    want = jpoint.farthest_point_sample(jnp.asarray(xyz), npoint)
    got = tpoint.farthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_farthest_point_sample_breaks_ties_like_jax():
    """Integer grid points: many exactly equal distances, each argmax
    taking the first index."""
    g = np.arange(4, dtype=np.float32)
    xyz = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
    xyz = np.concatenate([xyz, xyz[:, ::-1]])  # a second, reversed cloud
    want = jpoint.farthest_point_sample(jnp.asarray(xyz), 20, start_index=5)
    got = tpoint.farthest_point_sample(torch.from_numpy(xyz), 20,
                                       start_index=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_groups_match_jax_as_sets():
    rng = np.random.default_rng(9)
    xyz = rng.normal(size=(2, 200, 3)).astype(np.float32)
    centers = xyz[:, :16]
    want = np.sort(np.asarray(jpoint.knn_point(8, jnp.asarray(xyz),
                                               jnp.asarray(centers))), -1)
    got = np.sort(tpoint.knn_point(8, torch.from_numpy(xyz),
                                   torch.from_numpy(centers)).numpy(), -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,max_pool", [
    (torch.float32, False), (torch.float32, True), (torch.bfloat16, False)])
def test_point_bert_matches_jax(dtype, max_pool):
    cfg = dataclasses.replace(
        tpoint.PointBertTower("test:16x2", device="cpu").cfg,
        use_max_pool=max_pool)
    jcfg = jpoint.PointBertConfig(**dataclasses.asdict(cfg))
    tree = _randomize(jpoint.init_point_bert(jcfg, jax.random.PRNGKey(0)), 10)
    jp, tp = _pair(tree, dtype)
    points = np.random.default_rng(11).normal(size=(2, 64, 6)).astype(
        np.float32)
    want = jpoint.point_bert_features(jp, jcfg, jnp.asarray(points))
    got = tpoint.point_bert_features(tp, cfg, torch.from_numpy(points))
    assert got.shape == ((2, 1, 32) if max_pool else (2, 9, 16))
    _assert_close(got, want, FP32_TOL if dtype == torch.float32 else BF16_TOL)


def _point_state(cfg, rng):
    D, E, C = cfg.trans_dim, cfg.encoder_dims, cfg.point_dims
    I = int(D * cfg.mlp_ratio)
    sd = {"encoder.first_conv.0.weight": (128, C, 1),
          "encoder.first_conv.0.bias": (128,),
          "encoder.first_conv.3.weight": (256, 128, 1),
          "encoder.first_conv.3.bias": (256,),
          "encoder.second_conv.0.weight": (512, 512, 1),
          "encoder.second_conv.0.bias": (512,),
          "encoder.second_conv.3.weight": (E, 512, 1),
          "encoder.second_conv.3.bias": (E,),
          "reduce_dim.weight": (D, E), "reduce_dim.bias": (D,),
          "cls_token": (1, 1, D), "cls_pos": (1, 1, D),
          "pos_embed.0.weight": (128, 3), "pos_embed.0.bias": (128,),
          "pos_embed.2.weight": (D, 128), "pos_embed.2.bias": (D,),
          "norm.weight": (D,), "norm.bias": (D,)}
    for bn, d in (("encoder.first_conv.1", 128),
                  ("encoder.second_conv.1", 512)):
        for part in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{bn}.{part}"] = (d,)
    for i in range(cfg.depth):
        pre = f"blocks.blocks.{i}."
        sd[pre + "attn.qkv.weight"] = (3 * D, D)   # qkv_bias=False
        sd[pre + "attn.proj.weight"] = (D, D)
        sd[pre + "attn.proj.bias"] = (D,)
        sd[pre + "mlp.fc1.weight"] = (I, D)
        sd[pre + "mlp.fc1.bias"] = (I,)
        sd[pre + "mlp.fc2.weight"] = (D, I)
        sd[pre + "mlp.fc2.bias"] = (D,)
        for ln in ("norm1", "norm2"):
            sd[pre + ln + ".weight"] = (D,)
            sd[pre + ln + ".bias"] = (D,)
    state = {k: rng.normal(size=s).astype(np.float32)
             for k, s in sd.items()}
    for k in state:  # a BatchNorm variance is positive (a negative one
        if k.endswith("running_var"):  # makes the features NaN)
            state[k] = np.abs(state[k]) + np.float32(0.5)
    return state


def test_convert_point_bert_matches_jax(tmp_path, monkeypatch):
    cfg = tpoint.PointBertTower("test:16x2", device="cpu").cfg
    state = _point_state(cfg, np.random.default_rng(12))
    jcfg = jpoint.PointBertConfig(**dataclasses.asdict(cfg))
    want = jpoint.convert_point_bert(state, jcfg)
    _assert_same_tree(tpoint.convert_point_bert(state, cfg), want)
    # the tower's .pt loader ('state_dict' wrapper, module prefix stripped),
    # at the tiny size: the test spec names a file of the working directory
    monkeypatch.chdir(tmp_path)
    torch.save({"state_dict": {"module.point_encoder." + k:
                               torch.from_numpy(v) for k, v in state.items()}},
               "test:16x2")
    _assert_same_tree(
        tpoint.PointBertTower("test:16x2", device="cpu").params, want)


def test_point_processor_matches_jax():
    pc = np.random.default_rng(13).normal(size=(50, 6)).astype(np.float32)
    np.testing.assert_array_equal(tpoint.PointCloudProcessor.pc_norm(pc),
                                  jpoint.PointCloudProcessor.pc_norm(pc))
    np.testing.assert_array_equal(tpoint.PointCloudProcessor()([pc, pc]),
                                  jpoint.PointCloudProcessor()([pc, pc]))


# ---------------------------------------------------------------------------
# Q-Former projector
# ---------------------------------------------------------------------------

SPEC = "qformer_4N_2L"


@pytest.fixture(scope="module")
def qformer_tree():
    return _randomize(jproj.init_projector(SPEC, jax.random.PRNGKey(0), 16,
                                           24), 14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qformer_matches_jax(qformer_tree, dtype):
    jp, tp = _pair(qformer_tree, dtype)
    x = np.random.default_rng(15).normal(size=(2, 10, 16)).astype(np.float32)
    want = jproj.apply_projector(SPEC, jp, jnp.asarray(x))
    got = tproj.apply_projector(SPEC, tp, torch.from_numpy(x))
    assert got.shape == (2, 4, 24)
    _assert_close(got, want, FP32_TOL if dtype == torch.float32 else BF16_TOL)


def test_qformer_rejects_inputs_longer_than_its_position_table(qformer_tree):
    _, tp = _pair(qformer_tree, torch.float32)
    with pytest.raises(ValueError, match="position table holds 1024"):
        tproj.apply_projector(SPEC, tp, torch.zeros((1, 1025, 16)))


def test_qformer_init_has_the_jax_tree():
    got = tproj.init_projector(SPEC, torch.Generator().manual_seed(0), 16, 24)
    want = jproj.init_projector(SPEC, jax.random.PRNGKey(0), 16, 24)
    got_shapes = {p: tuple(t.shape) for p, t in tree_leaves(got)}
    want_shapes = {p: tuple(np.shape(a))
                   for p, a in tree_leaves(jax.tree.map(np.asarray, want))}
    assert got_shapes == want_shapes
    assert tproj.output_len(SPEC, 512) == 4


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_build_modal_encoders_builds_every_tower():
    cfg = tiny_test_config(mm_vision_encoder="test:32x2",
                           mm_audio_encoder="test:16x2",
                           mm_video_encoder="test:32x3",
                           mm_point_encoder="test:16x2")
    encs = build_modal_encoders(_port(cfg), torch.Generator().manual_seed(0),
                                device="cpu")
    assert {m: type(e).__name__ for m, e in encs.items()} == {
        "vision": "ClipVisionTower", "audio": "BeatsAudioTower",
        "video": "LanguageBindVideoTower", "point": "PointBertTower"}
    assert {m: e.hidden_size for m, e in encs.items()} == {
        "vision": 32, "audio": 16, "video": 32, "point": 16}


def test_clip_image_processor_matches_jax():
    from PIL import Image
    from modelcompose_tpu_torch.data.image_processing import \
        ClipImageProcessor
    jmod = importlib.import_module("modelcompose_tpu.data.image_processing")
    rng = np.random.default_rng(16)
    images = [Image.fromarray(rng.integers(0, 255, (40, 57, 3), np.uint8)),
              Image.fromarray(rng.integers(0, 255, (61, 30), np.uint8))]
    np.testing.assert_array_equal(ClipImageProcessor(28)(images),
                                  jmod.ClipImageProcessor(28)(images))
