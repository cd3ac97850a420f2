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


# ---------------------------------------------------------------------------
# The eval entry's data pipeline: conversation templates, tokenization,
# preprocess, the dataset and collator, image padding, the stop string
# ---------------------------------------------------------------------------

import modelcompose_tpu.data.conversation as jconv  # noqa: E402
import modelcompose_tpu.data.dataset as jdataset  # noqa: E402
import modelcompose_tpu.data.image_processing as jimage  # noqa: E402
import modelcompose_tpu.data.preprocess as jpre  # noqa: E402
import modelcompose_tpu.data.tokenization as jtok  # noqa: E402
import modelcompose_tpu.eval.generation_utils as jgen  # noqa: E402
import modelcompose_tpu_torch.data.conversation as tconv  # noqa: E402
import modelcompose_tpu_torch.data.dataset as tdataset  # noqa: E402
import modelcompose_tpu_torch.data.image_processing as timage  # noqa: E402
import modelcompose_tpu_torch.data.preprocess as tpre  # noqa: E402
import modelcompose_tpu_torch.data.tokenization as ttok  # noqa: E402
import modelcompose_tpu_torch.eval.generation_utils as tgen  # noqa: E402
from tests.fake_tokenizer import FakeLlamaTokenizer  # noqa: E402

TEMPLATES = sorted(jconv.conv_templates)


def _rendered(conv_module, name):
    conv = conv_module.conv_templates[name].copy()
    conv.append_message(conv.roles[0], "<image>\nWhat is shown?")
    conv.append_message(conv.roles[1], "A cat.")
    conv.append_message(conv.roles[0], "And the sound?")
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


@pytest.mark.parametrize("name", TEMPLATES)
def test_conversation_templates_match_jax(name):
    assert sorted(tconv.conv_templates) == TEMPLATES
    j, t = jconv.conv_templates[name], tconv.conv_templates[name]
    assert (t.system, t.roles, t.offset, t.sep_style.name, t.sep, t.sep2,
            t.version) == (j.system, j.roles, j.offset, j.sep_style.name,
                           j.sep, j.sep2, j.version)
    assert _rendered(tconv, name) == _rendered(jconv, name)
    assert tgen.stop_str_for(t) == jgen.stop_str_for(j)
    assert tconv.default_conversation.get_prompt() \
        == jconv.default_conversation.get_prompt()


@pytest.mark.parametrize("prompt", [
    "<image>\nWhat is this?", "plain text only", "a <audio> b <video> c",
    "<point><image>x</s>y", "<image>", ""])
def test_tokenization_matches_jax(prompt):
    tok = FakeLlamaTokenizer()
    for fmt in (None, "np", "pt"):
        got = ttok.tokenizer_modal_token(prompt, tok, return_tensors=fmt)
        want = jtok.tokenizer_modal_token(prompt, tok, return_tensors=fmt)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        got = ttok.tokenizer_image_token(prompt, tok, return_tensors=fmt)
        want = jtok.tokenizer_image_token(prompt, tok, return_tensors=fmt)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    seps = ["<image>", "<audio>"]
    assert ttok.split_string_by_list(prompt, seps) \
        == jtok.split_string_by_list(prompt, seps)
    for path in ("ckpts/merged-multimodal/", "a/b/checkpoint-300", "x"):
        assert ttok.get_model_name_from_path(path) \
            == jtok.get_model_name_from_path(path)


def _sources(plain):
    if plain:
        return [[{"from": "human", "value": "<image>\n"},
                 {"from": "gpt", "value": "a red car"}]]
    return [[{"from": "human", "value": "<image>\nWhat is it?"},
             {"from": "gpt", "value": "A car."},
             {"from": "human", "value": "Which colour?"},
             {"from": "gpt", "value": "Red."}],
            [{"from": "gpt", "value": "skipped lead"},
             {"from": "human", "value": "<audio> and <video>?"},
             {"from": "gpt", "value": ""}]]


@pytest.mark.parametrize("name", ["vicuna_v1", "llava_v1", "llama_2",
                                  "mpt", "plain", "v0"])
@pytest.mark.parametrize("has_image", [False, True])
def test_preprocess_matches_jax(name, has_image):
    tok = FakeLlamaTokenizer()
    outs = []
    for conv_module, pre in ((jconv, jpre), (tconv, tpre)):
        saved = conv_module.default_conversation
        conv_module.default_conversation = conv_module.conv_templates[name]
        try:
            outs.append(pre.preprocess(_sources(name == "plain"), tok,
                                       has_image=has_image))
        finally:
            conv_module.default_conversation = saved
    want, got = outs
    for key in ("input_ids", "labels"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_split_list_matches_jax(n):
    for length in range(12):
        lst = list(range(length))
        assert tdataset.split_list(lst, n) == jdataset.split_list(lst, n)
        for k in range(n):
            assert tdataset.get_chunk(lst, n, k) == jdataset.get_chunk(
                lst, n, k)


def _image(path, size):
    from PIL import Image
    rng = np.random.default_rng(size[0])
    Image.fromarray(rng.integers(0, 256, size[::-1] + (3,),
                                 dtype=np.uint8)).save(path)
    return str(path)


@pytest.mark.parametrize("aspect", [None, "pad"])
def test_image_padding_matches_jax(tmp_path, aspect):
    from PIL import Image
    imgs = [Image.open(_image(tmp_path / f"{w}.png", (w, 30))).convert("RGB")
            for w in (30, 50, 17)]
    np.testing.assert_array_equal(
        timage.expand2square(imgs[1], (1, 2, 3)),
        jimage.expand2square(imgs[1], (1, 2, 3)))
    got = timage.process_images(imgs, timage.ClipImageProcessor(size=28),
                                image_aspect_ratio=aspect)
    want = jimage.process_images(imgs, jimage.ClipImageProcessor(size=28),
                                 image_aspect_ratio=aspect)
    np.testing.assert_array_equal(got, want)


def _clips(path):
    """A stand-in video processor: a path -> [1, T, 2, 2, 3] with T from
    the name (one frame for a .jpg, as the real processor gives)."""
    t = 1 if path.endswith(".jpg") else 3
    return np.full((1, t, 2, 2, 3), len(path), np.float32)


def test_dataset_and_collator_match_jax(tmp_path):
    img = _image(tmp_path / "i.png", (40, 30))
    data = [{"id": i, "conversations": [
        {"from": "human", "value": v}, {"from": "gpt", "value": ""}],
        "modal_inputs": m} for i, (v, m) in enumerate([
            ("<image>\nWhat?", {"vision": [img]}),
            ("<video>\nWhen?", {"video": ["a.jpg"]}),
            ("<video>\nHow?", {"video": ["clip.mp4"]}),
            ("<audio>\n<point>\nWhy?", {"audio": ["x.wav"],
                                       "point": ["p.npy"]}),
            ("text only", {})])]
    path = tmp_path / "q.json"
    path.write_text(json.dumps(data))
    tok = FakeLlamaTokenizer()
    procs = {"vision": timage.ClipImageProcessor(size=28), "video": _clips,
             "audio": lambda items: (np.ones((len(items), 4, 2)),
                                     np.zeros((len(items), 4), bool)),
             "point": lambda items: np.full((len(items), 3), 7.0)}
    cfg = {"vision": {"image_aspect_ratio": "pad"}}
    saved = (jconv.default_conversation, tconv.default_conversation)
    jconv.default_conversation = jconv.conv_templates["vicuna_v1"]
    tconv.default_conversation = tconv.conv_templates["vicuna_v1"]
    try:
        for chunks, idx in ((1, 0), (2, 1)):
            jd = jdataset.ChunkedMultimodalDataset(str(path), tok, None, procs,
                                                   chunks, idx)
            td = tdataset.ChunkedMultimodalDataset(str(path), tok, None, procs,
                                                   chunks, idx)
            assert len(td) == len(jd)
            jcol = jdataset.DataCollatorForSupervisedDataset(tok, procs, cfg)
            tcol = tdataset.DataCollatorForSupervisedDataset(tok, procs, cfg)
            for start in range(0, len(td), 3):
                rows = range(start, min(start + 3, len(td)))
                want = jcol([jd[i] for i in rows])
                got = tcol([td[i] for i in rows])
                assert sorted(got) == sorted(want)
                for key in ("input_ids", "labels"):
                    for g, w in zip(got[key], want[key]):
                        np.testing.assert_array_equal(g, w)
                assert sorted(got.get("modal_inputs", {})) == sorted(
                    want.get("modal_inputs", {}))
                for m, w in want.get("modal_inputs", {}).items():
                    g = got["modal_inputs"][m]
                    if isinstance(w, dict):  # audio: fbank and mask
                        assert sorted(g) == sorted(w)
                        g, w = [g[k] for k in sorted(g)], [w[k] for k in
                                                           sorted(w)]
                    for a, b in zip(g if isinstance(g, list) else [g],
                                    w if isinstance(w, list) else [w]):
                        np.testing.assert_array_equal(a, b)
        # the collator tiles a one-frame clip to the batch's frame count
        full = tcol([tdataset.ChunkedMultimodalDataset(
            str(path), tok, None, procs)[i] for i in (1, 2)])
        assert full["modal_inputs"]["video"].shape == (2, 3, 2, 2, 3)
        # eval never resamples: a broken image raises
        data[0]["modal_inputs"] = {"vision": [img + ".missing"]}
        path.write_text(json.dumps(data))
        for mod in (jdataset, tdataset):
            with pytest.raises(FileNotFoundError):
                mod.ChunkedMultimodalDataset(str(path), tok, None, procs)[0]
    finally:
        jconv.default_conversation, tconv.default_conversation = saved
    assert tdataset.MultimodalDataset(str(path), tok).modality_lengths \
        == jdataset.MultimodalDataset(str(path), tok).modality_lengths


def test_generate_text_matches_jax():
    """generate_text passes a generator where the JAX one passes a key;
    tokenization, the greedy gate and the stop-string strip are the same."""
    class Model:
        def __init__(self):
            self.calls = []

        def generate(self, ids, modal_inputs, **kw):
            self.calls.append((np.asarray(ids[0]).tolist(), kw))
            return [[5, 9, 2]]

    class Tok(FakeLlamaTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            return super().decode(ids) + " ###"
    jm, tm = Model(), Model()
    kw = dict(temperature=1e-5, max_new_tokens=4, stop_str="###",
              num_beams=2, top_p=0.7)
    want = jgen.generate_text(jm, Tok(), "<image>\nhi", {}, rng="key", **kw)
    got = tgen.generate_text(tm, Tok(), "<image>\nhi", {}, generator="gen",
                             **kw)
    assert got == want == "t5 t9 t2"
    (jids, jkw), (tids, tkw) = jm.calls[0], tm.calls[0]
    assert tids == jids and tkw.pop("generator") == "gen" \
        and jkw.pop("rng") == "key"
    assert tkw == jkw and tkw["temperature"] == 0.0


# ---------------------------------------------------------------------------
# The train entry's sampler and prefetch loader
# ---------------------------------------------------------------------------

import modelcompose_tpu.data.loader as jloader  # noqa: E402
import modelcompose_tpu.train.sampler as jsampler  # noqa: E402
import modelcompose_tpu_torch.data.loader as tloader  # noqa: E402
import modelcompose_tpu_torch.train.sampler as tsampler  # noqa: E402


def _lengths(seed, n, signed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 400, n)
    if signed:  # text-only samples are negative
        lengths = np.where(rng.random(n) < 0.3, -lengths, lengths)
    return [int(x) for x in lengths]


@pytest.mark.parametrize("seed,n,signed", [(0, 1, False), (1, 7, False),
                                           (2, 37, True), (3, 64, True),
                                           (4, 13, True)])
def test_sampler_matches_jax(seed, n, signed):
    """Every function of the sampler copy gives the JAX module's indices in
    the JAX module's order, for the same lengths and generator seed."""
    lengths = _lengths(seed, n, signed)
    for num_chunks in (1, 2, 3):
        idx = list(range(n))[:n - n % num_chunks] or [0]
        assert tsampler.split_to_even_chunks(idx, lengths, num_chunks) \
            == jsampler.split_to_even_chunks(idx, lengths, num_chunks)
    for batch, world in ((1, 1), (4, 1), (3, 2)):
        for fn in ("get_length_grouped_indices",
                   "get_modality_length_grouped_indices"):
            if fn == "get_length_grouped_indices" and signed:
                lens = [abs(x) for x in lengths]
            else:
                lens = lengths
            got = getattr(tsampler, fn)(lens, batch, world,
                                        np.random.default_rng(seed))
            want = getattr(jsampler, fn)(lens, batch, world,
                                         np.random.default_rng(seed))
            assert got == want and sorted(got) == list(range(n)), fn


def test_modality_sampler_keeps_groups_apart():
    """Mixed-sign lengths: every full megabatch is all multimodal or all
    text-only, as in the JAX module (the tail megabatch mixes both)."""
    lengths = _lengths(5, 40, True)
    order = tsampler.get_modality_length_grouped_indices(
        lengths, 4, 1, np.random.default_rng(0))
    assert order == jsampler.get_modality_length_grouped_indices(
        lengths, 4, 1, np.random.default_rng(0))
    n_mm = sum(x > 0 for x in lengths)
    # each group's last megabatch (full or not) goes to the mixed tail
    tail = (n_mm % 4 or 4) + ((len(lengths) - n_mm) % 4 or 4)
    for i in range(0, len(order) - tail, 4):
        signs = {lengths[j] > 0 for j in order[i:i + 4]}
        assert len(signs) == 1, order[i:i + 4]
    with pytest.raises(AssertionError):
        tsampler.get_modality_length_grouped_indices([3, 0], 1, 1)


@pytest.mark.parametrize("num_workers", [0, 4])
def test_prefetch_loader_matches_jax(num_workers):
    """The same batches in the same order as the JAX loader, the trailing
    partial batch dropped, with synchronous and threaded collation."""
    import threading
    import time

    def collate(items):
        time.sleep(0.002 * (items[0] % 3))  # finish out of order
        return {"ids": list(items), "thread": threading.current_thread().name}

    dataset = list(range(100, 123))
    order = list(np.random.default_rng(0).permutation(len(dataset)))
    kw = dict(num_workers=num_workers, prefetch=2)
    got = list(tloader.PrefetchLoader(dataset, order, 4, collate, **kw))
    want = list(jloader.PrefetchLoader(dataset, order, 4, collate, **kw))
    assert len(tloader.PrefetchLoader(dataset, order, 4, collate, **kw)) \
        == len(got) == 5
    assert [b["ids"] for b in got] == [b["ids"] for b in want] == [
        [dataset[i] for i in order[j:j + 4]] for j in range(0, 20, 4)]
    main = threading.current_thread().name
    assert all((b["thread"] == main) == (num_workers == 0) for b in got)


def test_prefetch_loader_raises_and_stops_early():
    """A collate error reaches the consumer, and a consumer that stops
    early leaves no worker thread running."""
    import threading

    def bad(items):
        if 7 in items:
            raise ValueError("bad sample")
        return items
    before = threading.active_count()
    with pytest.raises(ValueError, match="bad sample"):
        list(tloader.PrefetchLoader(list(range(12)), range(12), 2, bad,
                                    num_workers=3))
    it = iter(tloader.PrefetchLoader(list(range(40)), range(40), 2,
                                     lambda x: x, num_workers=3, prefetch=1))
    assert next(it) == [0, 1]
    it.close()
    assert threading.active_count() == before
