"""The port's ImageBind audio tower (``models/audio_imagebind``) and its host
processor against the JAX package's, and the EVA + ImageBind composition
end to end.

Features at the ``imagebind-test`` size are held to 1e-5 of their largest
magnitude in fp32 and 2e-2 in bf16, on the same weights (a randomized JAX
tree carried across by ``params_from_jax``); the converted trees and the
processor's melspecs are held to be identical.  A tiny composition of an
``eva-test`` vision tower and an ``imagebind-test`` audio tower, carried
across by ``model_from_jax`` and loaded by both loaders from the same
files, gives the JAX greedy ids bit for bit.
"""

import dataclasses
import importlib
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import ModelConfig, tiny_test_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.models import audio_imagebind as jib
from modelcompose_tpu.models.model import MultimodalLM as JaxLM

from modelcompose_tpu_torch.compose.state_io import save_state
from modelcompose_tpu_torch.convert import model_from_jax
from modelcompose_tpu_torch.models import audio_imagebind as tib
from modelcompose_tpu_torch.models.loader import load_pretrained_model
from modelcompose_tpu_torch.models.vision_eva import EvaVisionTower
from tests.test_torch_compose import _perturbed, _write_base
from tests.test_torch_eva import _eva_state
from tests.test_torch_generate import _numpy_model, _perturb
from tests.test_torch_towers import (BF16_TOL, FP32_TOL, _assert_close,
                                     _assert_same_tree, _pair, _port,
                                     _randomize)

jaudio = importlib.import_module("modelcompose_tpu.data.audio_processing")
jloader = importlib.import_module("modelcompose_tpu.models.loader")
jconvert = importlib.import_module("modelcompose_tpu.compose.convert")
jproj = importlib.import_module("modelcompose_tpu.models.projectors")
jllama = importlib.import_module("modelcompose_tpu.core.llama")
taudio = importlib.import_module("modelcompose_tpu_torch.data.audio_processing")

SPEC = "imagebind-test:16x2"
EVA_SPEC = "eva-test:32x2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return tib.ImageBindAudioTower(SPEC, params={}).cfg


@pytest.mark.parametrize("dtype,clips", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True)])
def test_imagebind_features_match_jax(dtype, clips):
    cfg = _cfg()
    jcfg = jib.ImageBindAudioConfig(**dataclasses.asdict(cfg))
    tree = _randomize(jib.init_imagebind_audio(jcfg, jax.random.PRNGKey(0)),
                      1)
    jp, tp = _pair(tree, dtype)
    shape = ((2, 3) if clips else (2,)) + (1, cfg.num_mel_bins,
                                           cfg.target_len)
    mel = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = jib.imagebind_audio_features(jp, jcfg, jnp.asarray(mel))
    got = tib.imagebind_audio_features(tp, cfg, torch.from_numpy(mel))
    assert got.shape == shape[:-3] + (16,) and got.dtype == dtype
    _assert_close(got, want, FP32_TOL if dtype == torch.float32
                  else BF16_TOL)
    # the head normalizes each clip's row to the logit scale, 20
    np.testing.assert_allclose(got.float().norm(dim=-1).numpy(), 20.0,
                               rtol=1e-2 if dtype == torch.bfloat16
                               else 1e-5)


def test_imagebind_keys_include_the_learned_bias_position():
    """add_bias_kv: changing the learned key/value position changes every
    output (it is attended to, after the N tokens)."""
    cfg = _cfg()
    tp = tib.init_imagebind_audio(cfg, torch.Generator().manual_seed(0))
    mel = torch.randn(1, 3, 1, cfg.num_mel_bins, cfg.target_len,
                      generator=torch.Generator().manual_seed(1))
    before = tib.imagebind_audio_features(tp, cfg, mel)
    tp["layers"]["bias_v"].normal_(0, 1.0,
                                   generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(tib.imagebind_audio_features(tp, cfg, mel),
                              before, atol=1e-3)


def _imagebind_state(cfg, rng, other_modalities=True):
    """The audio keys of an ``imagebind_huge.pth`` state dict (and, when
    asked, a vision key the converter must skip)."""
    E, L, Fd = cfg.embed_dim, cfg.num_blocks, cfg.mlp_ratio * cfg.embed_dim
    k = cfg.kernel_size
    pre = "modality_preprocessors.audio."
    trunk = "modality_trunks.audio.blocks."
    sd = {pre + "rgbt_stem.proj.weight": (E, 1, k, k),
          pre + "rgbt_stem.norm_layer.weight": (E,),
          pre + "rgbt_stem.norm_layer.bias": (E,),
          pre + "cls_token": (1, 1, E),
          pre + "pos_embedding_helper.pos_embed": (1, cfg.num_patches + 1, E),
          "modality_heads.audio.0.weight": (E,),
          "modality_heads.audio.0.bias": (E,),
          "modality_heads.audio.2.weight": (cfg.out_embed_dim, E)}
    for i in range(L):
        b = f"{trunk}{i}."
        for ln in ("norm_1", "norm_2"):
            sd[b + ln + ".weight"] = sd[b + ln + ".bias"] = (E,)
        sd[b + "attn.in_proj_weight"] = (3 * E, E)
        sd[b + "attn.in_proj_bias"] = (3 * E,)
        sd[b + "attn.bias_k"] = sd[b + "attn.bias_v"] = (1, 1, E)
        sd[b + "attn.out_proj.weight"] = (E, E)
        sd[b + "attn.out_proj.bias"] = (E,)
        sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = (Fd, E), (Fd,)
        sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = (E, Fd), (E,)
    if other_modalities:
        sd["modality_preprocessors.vision.cls_token"] = (1, 1, 8)
    return {key: rng.normal(size=s).astype(np.float32)
            for key, s in sd.items()}


def test_convert_imagebind_audio_matches_jax():
    cfg = _cfg()
    state = _imagebind_state(cfg, np.random.default_rng(0))
    want = jib.convert_imagebind_audio(state, jib.ImageBindAudioConfig(
        **dataclasses.asdict(cfg)))
    _assert_same_tree(tib.convert_imagebind_audio(state, cfg), want)


@pytest.mark.parametrize("as_dir", [False, True])
def test_imagebind_tower_loads_imagebind_huge_pth(tmp_path, as_dir):
    """``load_model`` reads an ``imagebind_huge.pth`` torch pickle (a file,
    or a directory holding it) as the JAX tower does."""
    cfg = _cfg()
    state = _imagebind_state(cfg, np.random.default_rng(1))
    path = str(tmp_path / "imagebind_huge.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    tower = tib.ImageBindAudioTower(SPEC, params={})
    want = jib.convert_imagebind_audio(state, jib.ImageBindAudioConfig(
        **dataclasses.asdict(cfg)))
    if as_dir:
        tower.spec = str(tmp_path)
        got = tower.load_model(device="cpu", ckpt_path=os.path.join(
            tower.spec, "imagebind_huge.pth"))
    else:
        tower.spec = path
        got = tower.load_model(device="cpu")
    _assert_same_tree(got, want)


def test_imagebind_tower_protocol():
    tower = tib.ImageBindAudioTower(SPEC, device="cpu")
    assert (tower.hidden_size, tower.feature_len) == (16, 3)
    full = tib.ImageBindAudioConfig()
    assert full.grid == (12, 19) and full.num_patches == 228
    mel = tower.modal_processor(np.zeros(16000, np.float32))
    assert mel.shape == (1, 3, 1, 32, 46)
    assert tower.encode(mel).shape == (1, 3, 16)


# ---------------------------------------------------------------------------
# Processor (a numpy copy of the JAX one)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seconds", [10.0, 1.5])
@pytest.mark.parametrize("size", ["full", "test"])
def test_processor_copy_equals_jax(seconds, size):
    cfg = tib.ImageBindAudioConfig() if size == "full" else _cfg()
    wave_ = (np.random.default_rng(int(seconds * 10)).normal(
        size=int(seconds * 16000)) * 0.1).astype(np.float32)
    got = tib.ImageBindAudioProcessor(cfg)(wave_)
    want = jib.ImageBindAudioProcessor(jib.ImageBindAudioConfig(
        **dataclasses.asdict(cfg)))(wave_)
    assert got.shape == (1, 3, 1, cfg.num_mel_bins, cfg.target_len)
    np.testing.assert_array_equal(got, want)
    starts = tib.ImageBindAudioProcessor(cfg)._clip_starts(seconds)
    assert starts == jib.ImageBindAudioProcessor()._clip_starts(seconds)
    if seconds == 10.0:  # the divisor is clips_per_audio, not clips - 1
        assert starts == [0.0, 8.0 / 3, 16.0 / 3]


def test_processor_batches_waveforms_like_jax():
    rng = np.random.default_rng(4)
    waves = [rng.normal(size=n).astype(np.float32) * 0.1
             for n in (16000, 40000)]
    np.testing.assert_array_equal(tib.ImageBindAudioProcessor()(waves),
                                  jib.ImageBindAudioProcessor()(waves))


def test_processor_raises_on_a_path_in_both_packages(tmp_path):
    """A defect the port keeps: the processor takes waveforms only, and the
    collator and ``run_inference`` hand it file paths, so an ImageBind
    model cannot run a file-based entry in either package."""
    path = str(tmp_path / "clip.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(16000, np.int16).tobytes())
    for proc, collate in (
            (tib.ImageBindAudioProcessor(), taudio.collate_audio_inputs),
            (jib.ImageBindAudioProcessor(), jaudio.collate_audio_inputs)):
        with pytest.raises(ValueError):
            proc.process_one(path)
        with pytest.raises(ValueError):
            collate(proc, [path])


# ---------------------------------------------------------------------------
# The EVA + ImageBind composition
# ---------------------------------------------------------------------------

TOWERS = dict(mm_vision_encoder=EVA_SPEC, mm_hidden_size=32,
              mm_projector_type="mlp2x_gelu", mm_audio_encoder=SPEC,
              mm_audio_hidden_size=16,
              mm_audio_projector_type="qformer_4N_2L")


def _request(seed=5):
    img, aud = MODAL_TOKEN_INDEXES["vision"], MODAL_TOKEN_INDEXES["audio"]
    rng = np.random.default_rng(seed)
    ids = [np.array([1, img, 5, aud, 7, 8]), np.array([1, 6, aud, 9])]
    waves = [rng.normal(size=n).astype(np.float32) * 0.1
             for n in (48000, 24000)]
    return ids, {
        "vision": rng.normal(size=(1, 28, 28, 3)).astype(np.float32),
        "audio": jib.ImageBindAudioProcessor(jib.ImageBindAudioConfig(
            num_mel_bins=32, target_len=46))(waves)}


def test_composed_slice_greedy_ids_match_jax():
    """model_from_jax carries a tiny EVA + ImageBind model across (towers
    and their configs included): the port's greedy ids are the JAX
    ones."""
    cfg = tiny_test_config(local_prefix_tokens=2, local_suffix_tokens=2,
                           **TOWERS)
    jm = _perturb(JaxLM.random_init(cfg, jax.random.PRNGKey(3)), 3)
    for enc in jm.encoders.values():
        enc.params = _randomize(enc.params, 4)
    numpy_model = _numpy_model(jm)
    for modal, enc in numpy_model.encoders.items():
        enc.cfg = jm.encoders[modal].cfg
    tm = model_from_jax(numpy_model, device="cpu")
    assert {m: type(e).__name__ for m, e in tm.encoders.items()} == {
        "vision": "EvaVisionTower", "audio": "ImageBindAudioTower"}
    assert {m: tm.feature_span_len(m) for m in ("vision", "audio")} \
        == {m: jm.feature_span_len(m) for m in ("vision", "audio")} \
        == {"vision": 8, "audio": 8}
    ids, inputs = _request()
    want = jm.generate(ids, inputs, max_new_tokens=10, bucket_len=32)
    got = tm.generate(ids, inputs, max_new_tokens=10, bucket_len=32)
    assert got == want
    assert [len(r) for r in got] == [10, 10]


@pytest.fixture(scope="module")
def eva_imagebind_ckpt(tmp_path_factory):
    """A vision + audio DAMC checkpoint naming both towers, written by the
    JAX exporter, its Vicuna-layout base, and each tower's checkpoint
    under its spec's name (so both loaders load the same tower
    weights)."""
    root = str(tmp_path_factory.mktemp("eva_imagebind"))
    cfg = tiny_test_config(lora_alpha=8, local_prefix_tokens=1,
                           local_suffix_tokens=2, **TOWERS)
    params = jllama.init_params(cfg, jax.random.PRNGKey(11))
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_a"] = _perturbed(p["lora_a"], 12, 0.3)
            p["lora_b"] = _perturbed(p["lora_b"], 13, 0.3)
    for key in ("prefix_tokens", "suffix_tokens"):
        params[key] = _perturbed(params[key], 14, 0.5)
    projectors = {m: _perturbed(jproj.init_projector(
        cfg.projector_type(m), jax.random.PRNGKey(i),
        cfg.projector_input_size(m), cfg.hidden_size), 15 + i)
        for i, m in enumerate(("vision", "audio"))}
    path = os.path.join(root, "eva-imagebind-multimodal")
    os.makedirs(path)
    cfg.save(os.path.join(path, "config.json"))
    save_state(jconvert.params_to_adapter(params, cfg, projectors),
               os.path.join(path, "adapter_model.bin"))
    base, _ = _write_base(root, ModelConfig.load(
        os.path.join(path, "config.json")), seed=16)
    rng = np.random.default_rng(17)
    eva_cfg = EvaVisionTower(EVA_SPEC, _port(cfg), params={}).cfg
    for spec, state in ((EVA_SPEC, _eva_state(eva_cfg, rng, fused=False)),
                        (SPEC, _imagebind_state(_cfg(), rng))):
        torch.save({k: torch.from_numpy(v) for k, v in state.items()},
                   os.path.join(root, spec))
    return root, path, base


@pytest.mark.parametrize("load_8bit,fold", [(False, False), (True, True)])
def test_loader_serves_an_eva_imagebind_checkpoint_like_jax(
        eva_imagebind_ckpt, monkeypatch, load_8bit, fold):
    root, merged, base = eva_imagebind_ckpt
    monkeypatch.chdir(root)  # the tower specs name files here
    kw = dict(load_tokenizer_fn=lambda _: None, load_8bit=load_8bit,
              fold_decode_dense=fold)
    _, jm, jprocs, _ = jloader.load_pretrained_model(merged, base, **kw)
    _, tm, tprocs, _ = load_pretrained_model(merged, base, device="cpu", **kw)
    for modal in ("vision", "audio"):
        assert type(tm.encoders[modal]).__name__ \
            == type(jm.encoders[modal]).__name__
        _assert_same_tree(tm.encoders[modal].params,
                          jm.encoders[modal].params)
    assert type(tprocs["audio"]).__name__ == "ImageBindAudioProcessor"
    ids, inputs = _request(6)
    want = jm.generate(ids, inputs, max_new_tokens=8, bucket_len=32)
    got = tm.generate(ids, inputs, max_new_tokens=8, bucket_len=32)
    assert got == want and [len(r) for r in got] == [8, 8]


def test_encode_tower_takes_imagebind_arrays_as_they_are():
    """``MultimodalLM.encode_tower`` hands a melspec array to ``encode``
    unchanged and gets [n, clips, width] back: no ImageBind branch."""
    from modelcompose_tpu_torch import MultimodalLM
    cfg = _port(tiny_test_config(mm_audio_encoder=SPEC,
                                 mm_audio_hidden_size=16,
                                 mm_audio_projector_type="linear"))
    model = MultimodalLM.random_init(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    mel = model.modal_processors()["audio"](
        [np.zeros(16000, np.float32), np.ones(32000, np.float32) * 0.1])
    x = model.encode_tower("audio", mel)
    assert x.shape == (2, 3, 16)
    assert torch.equal(x, model.encoders["audio"].encode(mel))
