"""The port's checkpoint lifecycle tools against the JAX tools:
``compose/lifecycle`` (apply-delta, make-delta, consolidate,
merge-projectors, extract-projector, merge-lora), ``compose/
convert_llava_checkpoint`` (both subcommands), ``compose/
merge_deltas_to_base`` and ``ops/routed_lora.fold_default_adapter``.

The numpy tools must write the same keys, shapes, dtypes and values, bit
for bit; merge-lora loads the MCUB-4-shaped composition of
tests/test_torch_compose.py through each package's own loader and folds
the default-route adapters, so its dense export is held within 1e-5
(relative, fp32: the fold's einsum may sum in another order).  A
converted LLaVA-LoRA checkpoint loads in both packages' loaders.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelcompose_tpu.config import tiny_test_config
from modelcompose_tpu.core.llama import init_params as jax_init_params

import modelcompose_tpu_torch.compose.convert_llava_checkpoint as tllava
import modelcompose_tpu_torch.compose.lifecycle as tlife
import modelcompose_tpu_torch.compose.merge_deltas_to_base as tmdb
from modelcompose_tpu_torch.compose.state_io import load_state, save_state
from modelcompose_tpu_torch.models import loader as tloader
from modelcompose_tpu_torch.ops.routed_lora import fold_default_adapter
from tests.test_torch_compose import (  # noqa: F401
    _no_tokenizer, _perturbed, _write_base, composed_dir,
    composed_model_dirs)

jlife = importlib.import_module("modelcompose_tpu.compose.lifecycle")
jllava = importlib.import_module(
    "modelcompose_tpu.compose.convert_llava_checkpoint")
jmdb = importlib.import_module(
    "modelcompose_tpu.compose.merge_deltas_to_base")
jconvert = importlib.import_module("modelcompose_tpu.compose.convert")
jloader = importlib.import_module("modelcompose_tpu.models.loader")
jlora = importlib.import_module("modelcompose_tpu.ops.routed_lora")


def _assert_same_state(got_path, want_path):
    got, want = load_state(got_path), load_state(want_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _state(seed, keys, shape=(6, 4)):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shape).astype(np.float32) for k in keys}


@pytest.fixture
def weights(tmp_path):
    """A base and a target: shared backbone keys, a projector only in the
    target, the base as two safetensors shards."""
    backbone = ["model.layers.0.self_attn.q_proj.weight",
                "model.embed_tokens.weight"]
    base = _state(1, backbone)
    target = {k: v + 0.5 for k, v in _state(2, backbone).items()}
    target["model.mm_projector.0.weight"] = _state(3, ["p"])["p"]
    os.makedirs(tmp_path / "base")
    save_state({backbone[0]: base[backbone[0]]},
               str(tmp_path / "base" / "model-00001.safetensors"))
    save_state({backbone[1]: base[backbone[1]]},
               str(tmp_path / "base" / "model-00002.safetensors"))
    save_state(target, str(tmp_path / "target.bin"))
    return str(tmp_path / "base"), str(tmp_path / "target.bin")


@pytest.mark.parametrize("ext", [".safetensors", ".bin", ".npz"])
def test_delta_round_trip_matches_jax(tmp_path, weights, ext):
    base, target = weights
    for name, mod in (("jax", jlife), ("port", tlife)):
        mod.make_delta(base, target, str(tmp_path / f"delta-{name}{ext}"))
        mod.apply_delta(base, str(tmp_path / f"delta-{name}{ext}"),
                        str(tmp_path / f"target-{name}{ext}"))
    for what in ("delta", "target"):
        _assert_same_state(str(tmp_path / f"{what}-port{ext}"),
                           str(tmp_path / f"{what}-jax{ext}"))
    got = load_state(str(tmp_path / f"target-port{ext}"))
    want = load_state(target)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)


def test_apply_delta_rejects_a_foreign_key(tmp_path, weights):
    base, _ = weights
    save_state({"model.layers.9.mlp.up_proj.weight": np.zeros((2, 2),
                                                              np.float32)},
               str(tmp_path / "bad.safetensors"))
    for mod in (jlife, tlife):
        with pytest.raises(KeyError, match="not in the base"):
            mod.apply_delta(base, str(tmp_path / "bad.safetensors"),
                            str(tmp_path / "out.safetensors"))


def test_consolidate_merge_and_extract_projectors_match_jax(tmp_path,
                                                             weights):
    base, target = weights
    a = str(tmp_path / "a.safetensors")
    b = str(tmp_path / "b.bin")
    save_state(_state(4, ["model.mm_projector.0.weight", "x"]), a)
    save_state(_state(5, ["model.mm_projector.0.weight",
                          "model.modal_projectors.audio.0.bias"]), b)
    for name, mod in (("jax", jlife), ("port", tlife)):
        mod.consolidate(base, str(tmp_path / f"one-{name}.safetensors"))
        mod.merge_projectors([a, b], str(tmp_path / f"proj-{name}.bin"))
        mod.extract_projector(target, str(tmp_path / f"ex-{name}.npz"))
    for stem, ext in (("one", ".safetensors"), ("proj", ".bin"),
                      ("ex", ".npz")):
        _assert_same_state(str(tmp_path / f"{stem}-port{ext}"),
                           str(tmp_path / f"{stem}-jax{ext}"))
    assert list(load_state(str(tmp_path / "ex-port.npz"))) \
        == ["model.mm_projector.0.weight"]


def test_lifecycle_cli_runs_the_subcommands(tmp_path, weights):
    base, target = weights
    out = str(tmp_path / "delta.safetensors")
    tlife.main(["make-delta", "--base", base, "--target", target,
                "--delta", out])
    jlife.make_delta(base, target, str(tmp_path / "want.safetensors"))
    _assert_same_state(out, str(tmp_path / "want.safetensors"))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("row", [[1.0, 0.0, 0.0], [0.25, 2.0, -0.5]])
def test_fold_default_adapter_matches_jax(dtype, row):
    rng = np.random.default_rng(11)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    a = rng.normal(size=(3, 24, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4, 40)).astype(np.float32)
    want = np.asarray(jlora.fold_default_adapter(
        jnp.asarray(w, dtype), jnp.asarray(a, dtype), jnp.asarray(b, dtype),
        jnp.asarray(row, jnp.float32)), np.float32)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16

    def t(x):
        return torch.from_numpy(np.array(jnp.asarray(x, dtype),
                                         np.float32)).to(tdtype)
    got = fold_default_adapter(t(w), t(a), t(b), np.asarray(row, np.float32))
    assert got.dtype == tdtype
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:  # one bf16 rounding of an fp32 sum in another order
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=1e-6)
    # stacked layers: the same fold layer by layer
    stacked = fold_default_adapter(torch.stack([t(w), t(w) * 2]),
                                   torch.stack([t(a), t(a)]),
                                   torch.stack([t(b), -t(b)]),
                                   torch.tensor(row))
    np.testing.assert_array_equal(stacked[0].float().numpy(),
                                  got.float().numpy())


def test_merge_lora_dense_export_matches_jax(composed_model_dirs, tmp_path,
                                             monkeypatch):
    """Both packages' merge-lora on the same composition: every tensor of
    the dense export within 1e-5 of max |x|, the config the same, and the
    default-route fold visible (q_proj is not the base's)."""
    root, merged, base = composed_model_dirs
    monkeypatch.chdir(root)  # the towers' test: checkpoints
    jlife.merge_lora_to_dense(merged, base, str(tmp_path / "jax"))
    tlife.main(["merge-lora", "--model-path", merged, "--model-base", base,
                "--save-model-path", str(tmp_path / "port"), "--device",
                "cpu"])
    got = load_state(str(tmp_path / "port" / "model.safetensors"))
    want = load_state(str(tmp_path / "jax" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    with open(tmp_path / "port" / "config.json") as f, \
            open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)
    base_q = tloader.load_hf_llama_dir(base)[
        "model.layers.0.self_attn.q_proj.weight"]
    assert np.abs(got["model.layers.0.self_attn.q_proj.weight"]
                  - base_q).max() > 1e-3


def _llava_checkpoint(root, cfg, seed):
    """A LLaVA-LoRA vision checkpoint as LLaVA writes it: one adapter
    named ``default`` under peft's prefix, ``mm_projector`` and bare soft
    tokens, the base's own weights beside them, a config, a tokenizer
    file; exported from a DAMC vision tree by the JAX exporter."""
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    for grp in ("attn", "mlp"):
        for p in params["layers"][grp].values():
            p["lora_a"] = _perturbed(p["lora_a"], seed + 1, 0.3)
            p["lora_b"] = _perturbed(p["lora_b"], seed + 2, 0.3)
    for key in ("prefix_tokens", "suffix_tokens"):
        params[key] = _perturbed(params[key], seed + 3, 0.5)
    jproj = importlib.import_module("modelcompose_tpu.models.projectors")
    proj = _perturbed(jproj.init_projector(
        cfg.projector_type("vision"), jax.random.PRNGKey(seed),
        cfg.projector_input_size("vision"), cfg.hidden_size), seed + 4)
    damc = jconvert.params_to_adapter(params, cfg, {"vision": proj})
    state = {}
    for k, v in damc.items():
        if ".lora_A.default." in k or ".lora_B.default." in k:
            continue  # LLaVA trains one adapter: 'vision' becomes 'default'
        k = (k.replace(".vision.weight", ".default.weight")
             .replace("modal_projectors.vision", "mm_projector")
             .replace("prefix_tokens.vision", "prefix_tokens")
             .replace("suffix_tokens.vision", "suffix_tokens"))
        state["base_model.model." + k] = np.asarray(v, np.float32)
    state["base_model.model.model.embed_tokens.weight"] = np.zeros(
        (4, cfg.hidden_size), np.float32)  # not an adapter: dropped
    path = os.path.join(root, "llava-v1.5-7b-lora")
    os.makedirs(path)
    save_state(state, os.path.join(path, "pytorch_model.bin"))
    cfg.save(os.path.join(path, "config.json"))
    with open(os.path.join(path, "tokenizer.model"), "w") as f:
        f.write("tok")
    return path, damc


def test_convert_llava_checkpoint_matches_jax_and_loads(composed_model_dirs,
                                                        tmp_path,
                                                        monkeypatch):
    root, _, _ = composed_model_dirs
    monkeypatch.chdir(root)
    cfg = tiny_test_config(mm_vision_encoder="test:32x2", mm_hidden_size=32,
                           mm_projector_type="mlp2x_gelu",
                           lora_strategy="modal", local_prefix_tokens=1,
                           local_suffix_tokens=2)
    llava, damc = _llava_checkpoint(str(tmp_path), cfg, 40)
    outs = {}
    for name, mod in (("jax", jllava), ("port", tllava)):
        out = str(tmp_path / f"llava-vision-{name}-multimodal")
        outs[name] = out
        assert mod.convert_checkpoint(llava, out) == {
            "adapter_keys": sum(".lora_" in k and ".vision." in k
                                for k in damc),
            "non_lora_keys": sum(".lora_" not in k for k in damc)}
    for fname in ("adapter_model.bin", "non_lora_trainables.bin"):
        _assert_same_state(os.path.join(outs["port"], fname),
                           os.path.join(outs["jax"], fname))
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"]))
    # the converted keys are the DAMC export's 'vision' keys
    adapter = {k[len("base_model.model."):]: v for k, v in load_state(
        os.path.join(outs["port"], "adapter_model.bin")).items()}
    for k, v in adapter.items():
        np.testing.assert_array_equal(v, np.asarray(damc[k], np.float32))
    # and load in both loaders over the same base, to the same trees
    base, _ = _write_base(str(tmp_path), cfg, seed=41)
    kw = dict(load_tokenizer_fn=_no_tokenizer)
    _, jm, _, _ = jloader.load_pretrained_model(outs["port"], base, **kw)
    _, tm, _, _ = tloader.load_pretrained_model(outs["port"], base,
                                                device="cpu", **kw)
    from tests.test_torch_compose import _assert_same_tree
    _assert_same_tree(tm.params, jm.params)
    _assert_same_tree(tm.projectors, jm.projectors)
    lb = tm.params["layers"]["attn"]["q"]["lora_b"]
    assert lb[:, 1].abs().max() > 0 and lb[:, 0].abs().max() == 0


def test_convert_test_data_matches_jax(tmp_path):
    src = tmp_path / "q.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in [
        {"question_id": 3, "image": "a.png", "text": "What?",
         "category": "x"},
        {"question_id": "q4", "image": "sub/b.jpg", "text": "Where?"}])
        + "\n")
    for name, mod in (("jax", jllava), ("port", tllava)):
        mod.convert_test_data(str(src), str(tmp_path / "imgs"),
                              str(tmp_path / f"{name}.json"))
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "jax.json").read_text()


def _peft_checkpoint(root, name, seed, modal_cfg, hidden=8):
    d = os.path.join(root, name)
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    state = {}
    for i in range(2):
        for proj, d_out in (("self_attn.q_proj", hidden),
                            ("mlp.up_proj", 2 * hidden)):
            stem = f"base_model.model.model.layers.{i}.{proj}"
            state[f"{stem}.lora_A.weight"] = rng.normal(
                size=(2, hidden)).astype(np.float32)
            state[f"{stem}.lora_B.weight"] = rng.normal(
                size=(d_out, 2)).astype(np.float32)
    save_state(state, os.path.join(d, "adapter_model.bin"))
    save_state({"base_model.model.model.mm_projector.0.weight":
                rng.normal(size=(hidden, hidden)).astype(np.float32),
                "base_model.model.model.mm_projector.0.bias":
                rng.normal(size=(hidden,)).astype(np.float32),
                "base_model.model.prefix_tokens":
                rng.normal(size=(1, 2, hidden)).astype(np.float32)},
               os.path.join(d, "non_lora_trainables.bin"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"lora_alpha": 4, "r": 2}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(modal_cfg, f)
    return d


@pytest.mark.parametrize("strategy", ["avg", "sum"])
def test_merge_deltas_to_base_matches_jax(tmp_path, strategy):
    rng = np.random.default_rng(0)
    base = tmp_path / "base"
    base.mkdir()
    state = {}
    for i in range(2):
        state[f"model.layers.{i}.self_attn.q_proj.weight"] = rng.normal(
            size=(8, 8)).astype(np.float32)
        state[f"model.layers.{i}.mlp.up_proj.weight"] = rng.normal(
            size=(16, 8)).astype(np.float32)
    state["model.embed_tokens.weight"] = rng.normal(size=(16, 8)).astype(
        np.float32)
    save_state(state, str(base / "pytorch_model.bin"))
    (base / "config.json").write_text(json.dumps({"hidden_size": 8}))
    (base / "tokenizer.model").write_text("tok")
    ckpts = {"vision": _peft_checkpoint(str(tmp_path), "vis", 1, {
                 "mm_vision_encoder": "clip", "mm_hidden_size": 8}),
             "audio": _peft_checkpoint(str(tmp_path), "aud", 2, {
                 "mm_audio_encoder": "beats", "lora_r": 2})}
    stats = []
    for name, mod in (("jax", jmdb), ("port", tmdb)):
        stats.append(mod.merge_deltas_to_base(
            str(base), ckpts, str(tmp_path / name), strategy))
    assert stats[0] == stats[1] == {"merged_keys": 4, "overlay_keys": 5}
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "jax"))
    for fname in os.listdir(tmp_path / "jax"):
        if fname.endswith(".bin"):
            _assert_same_state(str(tmp_path / "port" / fname),
                               str(tmp_path / "jax" / fname))
        else:
            assert (tmp_path / "port" / fname).read_bytes() \
                == (tmp_path / "jax" / fname).read_bytes(), fname
    merged = tloader.load_hf_llama_dir(str(tmp_path / "port"))
    a = load_state(os.path.join(ckpts["vision"], "adapter_model.bin"))
    b = load_state(os.path.join(ckpts["audio"], "adapter_model.bin"))
    stem = "base_model.model.model.layers.1.mlp.up_proj"
    deltas = [(s[f"{stem}.lora_B.weight"] @ s[f"{stem}.lora_A.weight"]) * 2
              for s in (a, b)]
    agg = np.mean(deltas, 0) if strategy == "avg" else np.sum(deltas, 0)
    np.testing.assert_allclose(
        merged["model.layers.1.mlp.up_proj.weight"],
        state["model.layers.1.mlp.up_proj.weight"] + agg, rtol=1e-6)
