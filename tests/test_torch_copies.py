"""The port's own copies of the JAX package's framework-free modules
(``config``, ``constants``, ``compose.state_io``, ``compose.ties``, the
merge's modality lookup, the audio and video processors) against the
originals, on the same inputs.  Configs cross between the packages as
dicts (``to_dict`` / ``from_dict``) and as ``config.json`` files."""

import itertools
import json
import os

import numpy as np
import pytest

import modelcompose_tpu.compose.merge as jmerge
import modelcompose_tpu.compose.state_io as jstate
import modelcompose_tpu.compose.ties as jties
import modelcompose_tpu.config as jconfig
import modelcompose_tpu.constants as jconstants
import modelcompose_tpu.data.audio_processing as jaudio
import modelcompose_tpu.data.video_processing as jvideo
import modelcompose_tpu_torch.compose.merge as tmerge
import modelcompose_tpu_torch.compose.state_io as tstate
import modelcompose_tpu_torch.compose.ties as tties
import modelcompose_tpu_torch.config as tconfig
import modelcompose_tpu_torch.constants as tconstants
import modelcompose_tpu_torch.data.audio_processing as taudio
import modelcompose_tpu_torch.data.video_processing as tvideo

TOWERS = dict(mm_vision_encoder="clip", mm_hidden_size=1024,
              mm_audio_encoder="beats", mm_audio_hidden_size=768,
              mm_audio_projector_type="qformer_32N_2L",
              mm_video_encoder="languagebind", mm_video_hidden_size=1024,
              mm_point_encoder="pointbert", mm_point_hidden_size=384)


def _compositions():
    """Config dicts over the composition grid: each lora_strategy, 1 or 4
    modalities, plain / merge mode / online-merge-reset, per-modal stamps
    and soft-token overrides."""
    out = []
    for strategy, modals, merge in itertools.product(
            [None, "none", "same", "modal", "modal+language"],
            [("vision",), ("audio", "vision", "video", "point")],
            [None, "sum", "mean", "reset"]):
        kw = {k: v for k, v in TOWERS.items()
              if any(f"_{m}_" in k or (m == "vision" and k in (
                  "mm_vision_encoder", "mm_hidden_size")) for m in modals)}
        d = jconfig.ModelConfig(lora_strategy=strategy, lora_r=8,
                                lora_alpha=16, local_prefix_tokens=5,
                                local_suffix_tokens=5, **kw).to_dict()
        if merge == "reset":
            d["reset_scaling_weights"] = ",".join(
                f"default-{m}=0.{i + 2}" for i, m in enumerate(modals))
        elif merge is not None:
            d["merge_default_weights"] = merge
        d["vision_lora_alpha"] = 32
        d["local_audio_prefix_tokens"] = 3
        out.append(d)
    return out


@pytest.mark.parametrize("d", _compositions())
def test_config_round_trip_and_routing_match_jax(d):
    j = jconfig.ModelConfig.from_dict(d)
    t = tconfig.ModelConfig.from_dict(d)
    assert t.to_dict() == j.to_dict()
    # each side reads the other's dict and JSON
    assert tconfig.ModelConfig.from_dict(j.to_dict()).to_dict() == j.to_dict()
    assert jconfig.ModelConfig.from_dict(t.to_dict()).to_dict() == t.to_dict()
    assert json.dumps(t.to_dict(), sort_keys=True) == json.dumps(
        j.to_dict(), sort_keys=True)
    assert t.adapter_names() == j.adapter_names()
    assert t.modalities() == j.modalities()
    np.testing.assert_array_equal(t.adapter_scales(), j.adapter_scales())
    np.testing.assert_array_equal(t.routing_table(), j.routing_table())
    assert t.routing_active() == j.routing_active()
    assert t.head_dim == j.head_dim and hash(t) == hash(j)


def test_config_files_load_in_both_packages(tmp_path):
    d = _compositions()[-1]
    tconfig.ModelConfig.from_dict(d).save(str(tmp_path / "t.json"))
    jconfig.ModelConfig.from_dict(d).save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert jconfig.ModelConfig.load(str(tmp_path / "t.json")).to_dict() \
        == tconfig.ModelConfig.load(str(tmp_path / "j.json")).to_dict()


def test_tables_constants_and_helpers_match_jax():
    assert tconfig.ROUTE_CLASSES == jconfig.ROUTE_CLASSES
    assert tconfig.ROUTE_CLASS_INDEX == jconfig.ROUTE_CLASS_INDEX
    assert tconfig.NUM_ROUTE_CLASSES == jconfig.NUM_ROUTE_CLASSES
    spec = "default-video=0.333,default-audio=0.5"
    assert tconfig.parse_scaling_weights(spec) \
        == jconfig.parse_scaling_weights(spec)
    assert tconfig.tiny_test_config(lora_r=2).to_dict() \
        == jconfig.tiny_test_config(lora_r=2).to_dict()
    for name in dir(jconstants):
        if name.isupper():
            assert getattr(tconstants, name) == getattr(jconstants, name), name
    for cfg in ({"mm_audio_encoder": "beats"}, {"mm_vision_tower": "x"},
                {"mm_point_encoder": "p", "mm_video_encoder": ""}):
        assert tmerge.get_modal_from_config(cfg) \
            == jmerge.get_modal_from_config(cfg)
    with pytest.raises(AssertionError):
        tmerge.get_modal_from_config({"mm_vision_encoder": None})


def _deltas(rng, n):
    keys = [f"model.layers.{i}.self_attn.q_proj.lora_A.default.weight"
            for i in range(3)]
    return [{k: rng.normal(size=(4, 6)).astype(np.float32) for k in keys}
            for _ in range(n)]


@pytest.mark.parametrize("merge_func", ["dis-mean", "dis-sum", "dis-max"])
@pytest.mark.parametrize("K", [20, 0.7, 100])
def test_ties_matches_jax(merge_func, K):
    rng = np.random.default_rng(0)
    checks = _deltas(rng, 3)
    want = jties.do_merging(checks, K=K, merge_func=merge_func, lamda=0.7)
    got = tties.do_merging(checks, K=K, merge_func=merge_func, lamda=0.7)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_delta_to_ft_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _deltas(rng, 2)
    weights = {k: [a[k], b[k]] for k in a}
    weights["model.mm_projector.weight"] = [rng.normal(size=(2, 2))]
    (jft, juniq), (tft, tuniq) = (
        jties.convert_delta_to_ft(weights), tties.convert_delta_to_ft(weights))
    assert len(tft) == len(jft) and sorted(tuniq) == sorted(juniq)
    for jd, td in zip(jft, tft):
        assert sorted(jd) == sorted(td)
        assert all(np.array_equal(jd[k], td[k]) for k in jd)


@pytest.mark.parametrize("ext", [".bin", ".npz", ".safetensors"])
def test_state_io_crosses_packages(tmp_path, ext):
    rng = np.random.default_rng(2)
    state = {"base_model.model.model.layers.0.mlp.up_proj.lora_B.vision.weight":
             rng.normal(size=(3, 5)).astype(np.float32),
             "model.mm_projector.0.bias": rng.normal(size=(7,)).astype(
                 np.float32)}
    for save, load in ((tstate.save_state, jstate.load_state),
                       (jstate.save_state, tstate.load_state)):
        path = str(tmp_path / f"s{ext}")
        save(state, path)
        got = load(path)
        assert sorted(got) == sorted(state)
        assert all(np.array_equal(got[k], state[k]) for k in state)
    if ext == ".npz":  # not an adapter file name
        return
    os.makedirs(tmp_path / "ckpt")
    tstate.save_state(state, str(tmp_path / "ckpt" / f"adapter_model{ext}"))
    j = jstate.load_adapter_dir(str(tmp_path / "ckpt"))
    t = tstate.load_adapter_dir(str(tmp_path / "ckpt"))
    assert sorted(j) == sorted(t) and all(np.array_equal(j[k], t[k]) for k in j)
    assert tstate.find_adapter_file(str(tmp_path / "ckpt")) \
        == jstate.find_adapter_file(str(tmp_path / "ckpt"))


@pytest.mark.parametrize("window", ["povey", "hanning"])
def test_kaldi_fbank_matches_jax_numpy_path(window):
    wav = (np.random.RandomState(0).randn(16000) * 2 ** 15).astype(np.float32)
    want = jaudio.kaldi_fbank(wav, window_type=window, use_native=False)
    got = taudio.kaldi_fbank(wav, window_type=window)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (98, 128)
    np.testing.assert_array_equal(
        taudio.kaldi_mel_banks(128, 512, 16000),
        jaudio.kaldi_mel_banks(128, 512, 16000))


def test_beats_processor_matches_jax():
    """The port's processor (numpy fbank) is the JAX one with
    ``use_native=False`` exactly, and its default (which may take the
    native library) within the JAX tests' tolerance for that library."""
    rng = np.random.RandomState(1)
    clips = [rng.randn(16000 * 3).astype(np.float32) * 0.1,
             rng.randn(9000).astype(np.float32) * 0.1, "not-a-file.xyz"]
    got = taudio.BeatsAudioProcessor()(clips)
    jproc = jaudio.BeatsAudioProcessor()
    numpy_path = jaudio.kaldi_fbank
    try:
        jaudio.kaldi_fbank = lambda *a, **k: numpy_path(
            *a, **dict(k, use_native=False))
        exact = jproc(clips)
    finally:
        jaudio.kaldi_fbank = numpy_path
    default = jproc(clips)
    for g, e, d in zip(got, exact, default):
        assert g.shape == e.shape == d.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
        np.testing.assert_allclose(g, d, atol=2e-3, rtol=1e-3)
    for proc in (taudio.BeatsAudioProcessor(), lambda items: np.ones(3)):
        t = taudio.collate_audio_inputs(proc, clips[:2])
        j = jaudio.collate_audio_inputs(proc, clips[:2])
        if isinstance(j, dict):
            assert sorted(t) == sorted(j)
            np.testing.assert_allclose(t["audio_inputs"], j["audio_inputs"],
                                       atol=2e-3, rtol=1e-3)
            np.testing.assert_array_equal(t["audio_padding_mask"],
                                          j["audio_padding_mask"])
        else:
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("frames,size", [(8, 224), (12, 64), (8, 32)])
def test_video_processor_matches_jax(frames, size):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(frames)
    video = rng.integers(0, 256, (frames, 48, 80, 3), dtype=np.uint8)
    got = tvideo.LanguageBindVideoProcessor(num_frames=8, size=size)(video)
    want = jvideo.LanguageBindVideoProcessor(num_frames=8, size=size)(video)
    assert got.shape == want.shape == (1, 8, size, size, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvideo.uniform_frame_indices(31, 8),
                                  jvideo.uniform_frame_indices(31, 8))
