"""The PyTorch port's checkpoint converters, merge and loader against the
JAX package.

Reference-layout checkpoints are written by the JAX package's own exporters
(``params_to_hf_llama``, ``params_to_adapter``) from seeded random trees.
Converted trees, merged checkpoints and, at fp32, the 4-modality greedy ids
of a composed model loaded by both loaders must be identical.
"""

import filecmp
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.compose import convert as jconvert
from modelcompose_tpu.compose.merge import merge_checkpoints as jax_merge
from modelcompose_tpu.compose.state_io import load_state, save_state
from modelcompose_tpu.config import ModelConfig, tiny_test_config
from modelcompose_tpu.constants import MODAL_TOKEN_INDEXES
from modelcompose_tpu.core.llama import init_params as jax_init_params

from modelcompose_tpu_torch.compose import convert as tconvert
from modelcompose_tpu_torch.compose.merge import merge_checkpoints
from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.convert import params_from_jax, params_to_numpy
from modelcompose_tpu_torch.models import loader as tloader
from modelcompose_tpu_torch.tree import tree_leaves

jproj = importlib.import_module("modelcompose_tpu.models.projectors")
jloader = importlib.import_module("modelcompose_tpu.models.loader")

# One tower spec per modality, all distinct: each is also the name of the
# tower's checkpoint in the test's working directory.
MODALS = {
    "vision": dict(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                   mm_projector_type="mlp2x_gelu"),
    "audio": dict(mm_audio_encoder="test:16x2", mm_audio_hidden_size=16,
                  mm_audio_projector_type="qformer_4N_2L"),
    "video": dict(mm_video_encoder="test:32x3", mm_video_hidden_size=32,
                  mm_video_projector_type="mlp2x_gelu"),
    "point": dict(mm_point_encoder="test:24x2", mm_point_hidden_size=24,
                  mm_point_projector_type="linear"),
}
ALPHA = {"vision": 8, "audio": 16, "video": 8, "point": 4}  # r = 4
RESET = ("online-merge-reset-default-vision=0.25,default-audio=0.25,"
         "default-video=0.25,default-point=0.25")


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



def _perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.normal(0, scale, np.shape(a)), jnp.asarray(a).dtype), tree)


def _unimodal_cfg(modal, **kw):
    return tiny_test_config(lora_alpha=ALPHA[modal], local_prefix_tokens=1,
                            local_suffix_tokens=2, **MODALS[modal], **kw)


def _write_unimodal(root, modal, seed, **kw):
    """A unimodal DAMC checkpoint written by the JAX exporter: config.json
    and adapter_model.bin with every LoRA row, the projector and the soft
    tokens nonzero."""
    cfg = _unimodal_cfg(modal, **kw)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_a"] = _perturbed(p["lora_a"], seed + 1, 0.3)
            p["lora_b"] = _perturbed(p["lora_b"], seed + 2, 0.3)
    for key in ("prefix_tokens", "suffix_tokens"):
        params[key] = _perturbed(params[key], seed + 3, 0.5)
    d_in = cfg.projector_input_size(modal)
    proj = _perturbed(jproj.init_projector(
        cfg.projector_type(modal), jax.random.PRNGKey(seed), d_in,
        cfg.hidden_size), seed + 4)
    path = os.path.join(root, f"ckpt-{modal}")
    os.makedirs(path)
    cfg.save(os.path.join(path, "config.json"))
    save_state(jconvert.params_to_adapter(params, cfg, {modal: proj}),
               os.path.join(path, "adapter_model.bin"))
    return path


def _assert_same_tree(got_torch, want_jax):
    got = dict(tree_leaves(params_to_numpy(got_torch)))
    want = dict(tree_leaves(jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype.name ==
        "bfloat16" else np.asarray(a), want_jax)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
        assert got[path].dtype == want[path].dtype, path


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_llama_to_params_matches_jax(dtype):
    cfg = _unimodal_cfg("vision", dtype=dtype)
    state = jconvert.params_to_hf_llama(_perturbed(jax_init_params(
        cfg, jax.random.PRNGKey(0)), 1), cfg)
    _assert_same_tree(tconvert.hf_llama_to_params(state, _port(cfg)),
                      jconvert.hf_llama_to_params(state, cfg))


@pytest.mark.parametrize("spec,d_in", [("linear", 8), ("mlp2x_gelu", 8),
                                       ("mlp3x_gelu", 8),
                                       ("qformer_4N_2L", 16), ("identity", 8)])
def test_projector_from_reference_matches_jax(spec, d_in):
    tree = _perturbed(jproj.init_projector(spec, jax.random.PRNGKey(0), d_in,
                                           12), 2)
    prefix = "model.modal_projectors.audio"
    state = jconvert.projector_to_reference(spec, tree, prefix)
    got = tconvert.projector_from_reference(spec, state, prefix)
    _assert_same_tree(got, jconvert.projector_from_reference(spec, state,
                                                             prefix))
    # and back: the port's exporter writes the same reference keys
    exported = tconvert.projector_to_reference(spec, got, prefix)
    assert sorted(exported) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(exported[k], state[k])


@pytest.fixture(scope="module")
def composed_dir(tmp_path_factory):
    """Four unimodal checkpoints merged by the JAX package with
    online-merge-reset at 0.25 each (the MCUB-4 composition)."""
    root = str(tmp_path_factory.mktemp("compose"))
    paths = [_write_unimodal(root, m, 10 * i)
             for i, m in enumerate(MODALS)]
    merged = os.path.join(root, "mcub4-multimodal")
    jax_merge(paths, merged, RESET)
    return root, paths, merged


def test_load_adapter_into_params_matches_jax(composed_dir):
    _, _, merged = composed_dir
    cfg = ModelConfig.load(os.path.join(merged, "config.json"))
    modals = cfg.modalities()
    assert sorted(modals) == sorted(MODALS)
    assert cfg.adapter_names() == ["default"] + modals + [
        f"default-{m}" for m in modals]
    assert cfg.modal_lora_params["audio"] == {"r": 4, "alpha": 16}
    base = jconvert.params_to_hf_llama(jax_init_params(
        cfg, jax.random.PRNGKey(0)), cfg)
    adapter = load_state(os.path.join(merged, "adapter_model.bin"))
    adapter["model.layers.0.self_attn.q_proj.lora_A.unknown.weight"] = \
        np.zeros((4, 64), np.float32)
    adapter["model.layers.1.mlp.gate_proj.lora_B.default-speech.weight"] = \
        np.zeros((128, 4), np.float32)
    adapter["some.other.key"] = np.zeros(3, np.float32)
    jparams = jconvert.hf_llama_to_params(base, cfg)
    jproj_params = {}
    want_left = jconvert.load_adapter_into_params(jparams, adapter, cfg,
                                                  jproj_params)
    tparams = tconvert.hf_llama_to_params(base, _port(cfg))
    tproj_params = {}
    got_left = tconvert.load_adapter_into_params(tparams, adapter, _port(cfg),
                                                 tproj_params)
    assert got_left == want_left and len(got_left) == 3
    _assert_same_tree(tparams, jparams)
    _assert_same_tree(tproj_params, jproj_params)
    assert sorted(tproj_params) == sorted(MODALS)
    with pytest.raises(KeyError, match="unknown"):
        tconvert.load_adapter_into_params(
            tconvert.hf_llama_to_params(base, _port(cfg)), adapter,
            _port(cfg), {},
            strict=True)


def test_exporters_match_jax(composed_dir):
    _, _, merged = composed_dir
    cfg = ModelConfig.load(os.path.join(merged, "config.json"))
    jparams = _perturbed(jax_init_params(cfg, jax.random.PRNGKey(3)), 4)
    jprojs = {m: _perturbed(jproj.init_projector(
        cfg.projector_type(m), jax.random.PRNGKey(5),
        cfg.projector_input_size(m), cfg.hidden_size), 6) for m in MODALS}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    tprojs = params_from_jax(jax.tree.map(np.asarray, jprojs))
    for got, want in (
            (tconvert.params_to_adapter(tparams, _port(cfg), tprojs),
             jconvert.params_to_adapter(jparams, cfg, jprojs)),
            (tconvert.params_to_hf_llama(tparams, _port(cfg)),
             jconvert.params_to_hf_llama(jparams, cfg))):
        assert sorted(got) == sorted(want)  # jax.tree.map sorts dicts
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------

def _read_merged(path):
    state = load_state(os.path.join(path, "adapter_model.bin"))
    with open(os.path.join(path, "config.json")) as f:
        text = f.read()
    with open(os.path.join(path, "merge_info.txt")) as f:
        info = f.read().replace(path, "OUT")
    return state, text, info


@pytest.fixture(scope="module")
def naive_dirs(tmp_path_factory):
    """NaiveMC ('same'-strategy) vision and audio checkpoints: one
    'default' adapter each, for the convert-* strategies."""
    root = str(tmp_path_factory.mktemp("naive"))
    return [_write_unimodal(root, m, 50 + i, lora_strategy="same")
            for i, m in enumerate(("vision", "audio"))]


@pytest.mark.parametrize("strategy", [
    "sum", "mean", "ties-sum", "ties-mean", "ties-max",
    "online-merge-mean", RESET, "convert-sum", "convert-ties-mean",
    "convert-drop-mean", "convert-online-merge-reset-default-vision=0.5,"
    "default-audio=0.5"])
def test_merge_matches_jax(composed_dir, naive_dirs, tmp_path, strategy):
    _, paths, _ = composed_dir
    inputs = naive_dirs if strategy.startswith("convert-") else paths[:2]
    if strategy == RESET:
        inputs = paths
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_merge(inputs, want_dir, strategy)
    merge_checkpoints(inputs, got_dir, strategy)
    want, got = _read_merged(want_dir), _read_merged(got_dir)
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    assert got[1] == want[1]  # config.json, byte for byte
    assert got[2] == want[2]
    # the .safetensors copy, written here because the package imports
    assert filecmp.cmp(os.path.join(got_dir, "adapter_model.safetensors"),
                       os.path.join(want_dir, "adapter_model.safetensors"),
                       shallow=False)


def test_merge_without_safetensors_writes_bin_only(composed_dir, tmp_path,
                                                   monkeypatch):
    _, paths, _ = composed_dir
    monkeypatch.setitem(sys.modules, "safetensors", None)
    out = str(tmp_path / "out")
    merge_checkpoints(paths[:2], out, "sum")
    assert sorted(os.listdir(out)) == ["adapter_model.bin", "config.json",
                                       "merge_info.txt"]


def test_merge_rejects_an_unknown_strategy(composed_dir, tmp_path):
    _, paths, _ = composed_dir
    with pytest.raises(ValueError, match="not implemented"):
        merge_checkpoints(paths[:2], str(tmp_path / "out"), "median")


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

def _write_base(root, cfg, seed=0, layout="index"):
    """The Vicuna-layout base of ``cfg``: two ``pytorch_model-*.bin``
    shards and their index (``layout='index'``), or one file of another
    format."""
    state = jconvert.params_to_hf_llama(_perturbed(jax_init_params(
        cfg, jax.random.PRNGKey(seed)), seed + 1), cfg)
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    path = os.path.join(root, f"vicuna-{layout}")
    os.makedirs(path)
    if layout == "index":
        keys = sorted(state)
        shards = {"pytorch_model-00001-of-00002.bin": keys[::2],
                  "pytorch_model-00002-of-00002.bin": keys[1::2]}
        for name, ks in shards.items():
            save_state({k: state[k] for k in ks}, os.path.join(path, name))
        with open(os.path.join(path, "pytorch_model.bin.index.json"),
                  "w") as f:
            json.dump({"weight_map": {k: n for n, ks in shards.items()
                                      for k in ks}}, f)
    else:
        save_state(state, os.path.join(path, {
            "bin": "pytorch_model.bin", "npz": "model.npz",
            "safetensors": "model.safetensors"}[layout]))
    return path, state


@pytest.mark.parametrize("layout", ["index", "bin", "npz", "safetensors"])
def test_load_hf_llama_dir_reads_every_layout(tmp_path, layout):
    cfg = _unimodal_cfg("vision")
    path, state = _write_base(str(tmp_path), cfg, layout=layout)
    got = tloader.load_hf_llama_dir(path)
    want = jloader.load_hf_llama_dir(path)
    assert sorted(got) == sorted(want) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])


def test_load_hf_llama_dir_raises_without_safetensors(tmp_path, monkeypatch):
    path, _ = _write_base(str(tmp_path), _unimodal_cfg("vision"),
                          layout="safetensors")
    # the submodule too: an earlier test of this process may have imported
    # it, and a cached submodule is found without its parent
    for name in ("safetensors", "safetensors.numpy"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="safetensors"):
        tloader.load_hf_llama_dir(path)


def _write_towers(root):
    """Each tower's checkpoint under its ``test:`` spec, in the reference
    layout, so both loaders load the same tower weights."""
    from tests.test_torch_towers import (_beats_state, _clip_state,
                                         _point_state)
    from modelcompose_tpu_torch.models.audio_beats import BeatsAudioTower
    from modelcompose_tpu_torch.models.point_bert import PointBertTower
    from modelcompose_tpu_torch.models.towers import ClipVisionTower
    from modelcompose_tpu_torch.models.video_languagebind import \
        LanguageBindVideoTower
    import dataclasses
    rng = np.random.default_rng(7)
    cfg = _unimodal_cfg("vision")
    for spec, tower_cfg, temporal in (
            ("test:32x2",
             ClipVisionTower("test:32x2", cfg, device="cpu").cfg, False),
            ("test:32x3",
             LanguageBindVideoTower("test:32x3", device="cpu").cfg, True)):
        os.makedirs(os.path.join(root, spec))
        save_state(_clip_state(tower_cfg, rng, temporal),
                   os.path.join(root, spec, "pytorch_model.bin"))
    # A BEATs file's cfg has no fbank_bins (as a public checkpoint's): the
    # loaded tower takes BEATs' 128 bins, so the tiny tower patches them as
    # BEATs does, 16 x 16 (a 64-frame window: 4 x 8 = 32 tokens).
    beats = dataclasses.replace(
        BeatsAudioTower("test:16x2", device="cpu").cfg, input_patch_size=16,
        fbank_bins=128)
    torch.save({"cfg": {k: v for k, v in dataclasses.asdict(beats).items()
                        if k != "fbank_bins"},
                "model": {k: torch.from_numpy(v) for k, v in
                          _beats_state(beats, rng).items()}},
               os.path.join(root, "test:16x2"))
    point = PointBertTower("test:24x2", device="cpu").cfg
    torch.save({k: torch.from_numpy(v) for k, v in
                _point_state(point, rng).items()},
               os.path.join(root, "test:24x2"))
    _assert_towers_finite(root)


def _assert_towers_finite(root):
    """Every tower loaded from the files above gives finite features."""
    from modelcompose_tpu_torch.models.towers import tower_class
    rng = np.random.default_rng(8)
    inputs = {"vision": rng.normal(size=(1, 28, 28, 3)),
              "audio": rng.normal(size=(1, 64, 128)),
              "video": rng.normal(size=(1, 2, 28, 28, 3)),
              "point": rng.normal(size=(1, 64, 6))}
    cwd = os.getcwd()
    os.chdir(root)  # the ``test:`` specs name files here
    try:
        for modal, kw in MODALS.items():
            cfg = _port(_unimodal_cfg(modal))
            spec = cfg.encoder_spec(modal)
            tower = tower_class(modal, spec)(spec, cfg, device="cpu")
            out = tower.encode(torch.from_numpy(
                inputs[modal].astype(np.float32)))
            feats = out[0] if isinstance(out, tuple) else out
            assert torch.isfinite(feats).all(), modal
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def composed_model_dirs(composed_dir):
    root, _, merged = composed_dir
    _write_towers(root)
    base, _ = _write_base(root, ModelConfig.load(
        os.path.join(merged, "config.json")), seed=20)
    return root, merged, base


def _requests():
    """Two prompts: all four modalities, then an image and an audio clip
    (the second clip half padding)."""
    img, aud, vid, pt = (MODAL_TOKEN_INDEXES[m] for m in
                         ("vision", "audio", "video", "point"))
    rng = np.random.default_rng(30)
    ids = [np.array([1, img, 5, aud, 7, vid, 9, pt, 11, 12]),
           np.array([1, 6, aud, 8, img, 10])]
    mask = np.zeros((2, 64), bool)
    mask[1, 32:] = True
    inputs = {
        "vision": rng.normal(size=(2, 28, 28, 3)).astype(np.float32),
        "audio": {"audio_inputs": rng.normal(size=(2, 64, 128)).astype(
                      np.float32),
                  "audio_padding_mask": mask},
        "video": rng.normal(size=(1, 2, 28, 28, 3)).astype(np.float32),
        "point": rng.normal(size=(1, 64, 6)).astype(np.float32),
    }
    return ids, inputs


def _no_tokenizer(_):
    return None


@pytest.mark.parametrize("load_8bit,fold,compact", [
    (False, False, False), (True, False, False), (False, True, True),
    (True, True, True)])
def test_composed_greedy_ids_match_jax(composed_model_dirs, monkeypatch,
                                       load_8bit, fold, compact):
    """The MCUB-4-shaped composition loaded by both loaders from the same
    files answers the same 4-modality batch with the same greedy ids."""
    root, merged, base = composed_model_dirs
    monkeypatch.chdir(root)
    kw = dict(load_tokenizer_fn=_no_tokenizer, load_8bit=load_8bit,
              fold_decode_dense=fold)
    _, jm, jprocs, jlen = jloader.load_pretrained_model(merged, base, **kw)
    _, tm, tprocs, tlen = tloader.load_pretrained_model(merged, base,
                                                        device="cpu", **kw)
    assert tlen == jlen and sorted(tprocs) == sorted(jprocs)
    np.testing.assert_array_equal(np.asarray(tm.routing_table),
                                  np.asarray(jm.routing_table))
    if not fold:  # every loaded leaf, quantized or not, is the JAX one
        _assert_same_tree(tm.params, jm.params)
        _assert_same_tree(tm.projectors, jm.projectors)
    for modal in MODALS:
        _assert_same_tree(tm.encoders[modal].params, jm.encoders[modal].params)
        assert tm.feature_span_len(modal) == jm.feature_span_len(modal)
    ids, inputs = _requests()
    want = jm.generate(ids, inputs, max_new_tokens=8, bucket_len=64,
                       compact_adapters=compact)
    got = tm.generate(ids, inputs, max_new_tokens=8, bucket_len=64,
                      compact_adapters=compact)
    assert got == want
    assert [len(r) for r in got] == [8, 8]
    if compact:  # 'default' is unreachable after online-merge-reset
        assert list(tm._compact_cache) == list(jm._compact_cache)
        assert 0 not in list(tm._compact_cache)[0]


def test_composition_changes_the_answer(composed_model_dirs, monkeypatch):
    """Guard for the parity test: the reset coefficients are live, so the
    same files with the default-* rows scaled up answer differently."""
    root, merged, base = composed_model_dirs
    monkeypatch.chdir(root)
    _, tm, _, _ = tloader.load_pretrained_model(
        merged, base, load_tokenizer_fn=_no_tokenizer, device="cpu")
    ids, inputs = _requests()
    before = tm.generate(ids, inputs, max_new_tokens=8, bucket_len=64)
    tm.routing_table = np.asarray(tm.routing_table) * np.where(
        np.arange(9) >= 5, 40.0, 1.0)[None].astype(np.float32)
    assert tm.generate(ids, inputs, max_new_tokens=8, bucket_len=64) \
        != before


def test_loader_argument_checks(composed_model_dirs, tmp_path):
    _, merged, base = composed_model_dirs
    with pytest.raises(ValueError, match="multimodal"):
        tloader.load_pretrained_model(merged, base, model_name="vicuna")
    with pytest.raises(ValueError, match="model-base"):
        tloader.load_pretrained_model(merged, None)
    # tensor parallelism needs as many processes as tp, as the JAX loader
    # needs as many devices
    with pytest.raises(ValueError, match="--tp 2 needs 2 processes, have 1"):
        tloader.load_pretrained_model(merged, base, tp=2)


def test_default_tokenizer_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="load_tokenizer_fn"):
        tloader.load_tokenizer("vicuna")


# ---------------------------------------------------------------------------
# Compaction at the MCUB-4 composition
# ---------------------------------------------------------------------------

def test_mcub4_active_adapter_set_matches_jax():
    """The full-width MCUB-4 config, folded: every route class of a 4-modal
    prompt reaches 8 of the 9 adapter rows (all but the dead 'default'),
    on both sides (the count the smoke script holds the card to)."""
    from modelcompose_tpu.config import ROUTE_CLASS_INDEX
    from modelcompose_tpu.ops import routed_lora as jrl
    from modelcompose_tpu_torch.configs import mcub4_damc_7b
    from modelcompose_tpu_torch.ops import routed_lora as trl
    cfg = mcub4_damc_7b()
    table = cfg.routing_table()
    folded = table - table[0][None]
    classes = [0] + [ROUTE_CLASS_INDEX[m] for m in MODALS]
    want = jrl.active_adapter_set(folded, classes)
    assert trl.active_adapter_set(folded, classes) == want
    assert trl.active_adapter_set(table, classes) == want
    assert want == tuple(range(1, 9))


@pytest.mark.parametrize("active", [(1, 2, 3), (0, 2, 3), ()])
def test_compact_active_adapters_matches_jax(active):
    from modelcompose_tpu.ops import routed_lora as jrl
    from modelcompose_tpu_torch.ops import routed_lora as trl
    cfg = tiny_test_config(mm_vision_encoder="test:32x2",
                           mm_audio_encoder="test:16x2",
                           reset_scaling_weights="default-vision=0.5,"
                                                 "default-audio=0.5")
    jparams = _perturbed(jax_init_params(cfg, jax.random.PRNGKey(0)), 1)
    table = cfg.routing_table()
    want_params, want_table = jrl.compact_active_adapters(jparams, table,
                                                          active)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    got_params, got_table = trl.compact_active_adapters(tparams, table,
                                                        active)
    _assert_same_tree(got_params, want_params)
    np.testing.assert_array_equal(got_table.numpy(), np.asarray(want_table))
    # a contiguous run (the empty set keeps column 0) is a view: no second
    # adapter tree
    q = got_params["layers"]["attn"]["q"]["lora_a"]
    shares = q.untyped_storage().data_ptr() == tparams["layers"]["attn"][
        "q"]["lora_a"].untyped_storage().data_ptr()
    assert shares == (active != (0, 2, 3))
