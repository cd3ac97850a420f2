"""The port's training entry against the JAX package's (tiny configs, fp32,
CPU): ``train()`` end to end in stage 1 and stage 2, the step checkpoints
and resume, the exports, and ``build_model`` from an HF base on disk.

Both packages draw the same random weights: their ``init_params``,
``build_modal_encoders`` and ``init_projector`` are patched to return one
numpy tree each (made by the port's initializers from fixed seeds), so
everything else of both ``build_model`` functions runs as written.  JAX
sees one CPU device (``jax.devices`` patched; the repo's conftest makes
eight), so its ``train()`` takes its single-device path, the port's
semantics.  The model's sizes come from the ``config.json`` of a tiny HF
base directory (2 layers, width 64, vocabulary 256), which
``build_model_config`` reads in both packages.

Tolerances: per-step losses and exported tensors within 1e-5 relative
(fp32; the JAX step runs its Pallas attention in interpret mode); a
resumed run bit-equal to an uninterrupted one; loaded checkpoints bit-equal
to the files.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import modelcompose_tpu.core.llama as jllama
import modelcompose_tpu.models.projectors as jprojectors
import modelcompose_tpu.models.towers as jtowers
from modelcompose_tpu.compose.state_io import load_state as jload_state
from modelcompose_tpu.models.loader import load_hf_llama_dir as jload_hf
from modelcompose_tpu.ops.quant import quantize_backbone as jquantize
from modelcompose_tpu.train import train_multimodal as jentry

from modelcompose_tpu_torch.compose.convert import params_to_hf_llama
from modelcompose_tpu_torch.compose.state_io import load_state
from modelcompose_tpu_torch.config import ModelConfig as PortConfig
from modelcompose_tpu_torch.config import tiny_test_config
from modelcompose_tpu_torch.convert import params_from_jax, params_to_numpy
from modelcompose_tpu_torch.core.llama import init_params
from modelcompose_tpu_torch.models.loader import (load_hf_llama_dir,
                                                  load_pretrained_model)
from modelcompose_tpu_torch.models.projectors import init_projector
from modelcompose_tpu_torch.models.towers import tower_class
from modelcompose_tpu_torch.train import checkpoint as tckpt
from modelcompose_tpu_torch.train import train_multimodal as entry
from modelcompose_tpu_torch.tree import tree_leaves
from tests import fake_tokenizer
from tests.fake_tokenizer import FakeLlamaTokenizer

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
TOL = 1e-5
# Adam's eps in both packages' entries.  At the default 1e-8, an element
# whose first moment nearly cancels between steps moves by an amount set by
# the summation order (the Adam parity trap): such elements of the exported
# LoRA B differed by up to 1e-3 of max |B| after three steps at lr 1e-3.
# At 1e-2 eps bounds that sensitivity, and the optimizer itself is held to
# optax at the default eps in tests/test_torch_train.py.
ADAM_EPS = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fixed_word_ids():
    """``FakeLlamaTokenizer`` maps a word through the builtin ``hash``,
    which Python salts per process: the token ids, and with them every loss
    and how close the two packages land, would change from run to run.
    crc32 fixes the ids."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fake_tokenizer, "hash",
                   lambda w: zlib.crc32(w.encode()), raising=False)
        yield


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Data, the tiny HF base and the shared weights
# ---------------------------------------------------------------------------

def _hf_state(seed=0):
    """A Llama state dict at TINY's sizes in the HF [out, in] layout."""
    rng = np.random.default_rng(seed)
    H, I, V = TINY["hidden_size"], TINY["intermediate_size"], \
        TINY["vocab_size"]
    state = {"model.embed_tokens.weight": rng.normal(0, 0.02, (V, H)),
             "model.norm.weight": 1 + rng.normal(0, 0.1, H),
             "lm_head.weight": rng.normal(0, 0.02, (V, H))}
    for i in range(TINY["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (H, H)),
                            ("self_attn.k_proj", (H, H)),
                            ("self_attn.v_proj", (H, H)),
                            ("self_attn.o_proj", (H, H)),
                            ("mlp.gate_proj", (I, H)), ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            state[pre + name + ".weight"] = rng.normal(0, 0.05, shape)
        for name in ("input_layernorm", "post_attention_layernorm"):
            state[pre + name + ".weight"] = 1 + rng.normal(0, 0.1, H)
    return {k: v.astype(np.float16) for k, v in state.items()}


def _write_hf_base(path, state):
    """Two fp16 shards with their index and a Llama config.json, as the
    released Vicuna directory has them."""
    os.makedirs(path, exist_ok=True)
    keys = sorted(state)
    shards = {"pytorch_model-00001-of-00002.bin": keys[::2],
              "pytorch_model-00002-of-00002.bin": keys[1::2]}
    for name, ks in shards.items():
        torch.save({k: torch.from_numpy(state[k]) for k in ks},
                   os.path.join(path, name))
    with open(os.path.join(path, "pytorch_model.bin.index.json"), "w") as f:
        json.dump({"weight_map": {k: n for n, ks in shards.items()
                                  for k in ks}}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(TINY, architectures=["LlamaForCausalLM"],
                       model_type="llama", rms_norm_eps=1e-5), f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    base = str(root / "vicuna-tiny")
    _write_hf_base(base, _hf_state())
    rs = np.random.RandomState(0)
    data = []
    for i in range(4):
        img = str(root / f"img{i}.png")
        Image.fromarray((rs.rand(32, 32, 3) * 255).astype(np.uint8)).save(img)
        data.append({"id": i, "conversations": [
            {"from": "human", "value": "<image>\nwhat is it"},
            {"from": "gpt", "value": f"thing {i}"}],
            "modal_inputs": {"vision": [img]}})
    data.append({"id": 99, "conversations": [
        {"from": "human", "value": "hello there"},
        {"from": "gpt", "value": "hi"}]})
    path = str(root / "train.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return {"root": root, "base": base, "data": path}


def _np_backbone(cfg_dict):
    cfg = PortConfig.from_dict(cfg_dict)
    return params_to_numpy(init_params(cfg, torch.Generator().manual_seed(2),
                                       "cpu"))


def _np_tower(modal, spec):
    return params_to_numpy(tower_class(modal, spec)(
        spec, tiny_test_config(), generator=torch.Generator().manual_seed(1),
        device="cpu").params)


def _np_projector(spec, d_in, d_out):
    return params_to_numpy(init_projector(
        spec, torch.Generator().manual_seed(3), d_in, d_out,
        dtype=torch.float32, device="cpu"))


@contextlib.contextmanager
def shared_weights():
    """Both packages' random initializers return the same trees, and JAX
    sees one device."""
    one = jax.devices()[:1]

    def port_params(cfg, generator, device=None):
        return params_from_jax(_np_backbone(cfg.to_dict()), device)

    def port_towers(cfg, generator=None, device=None, dtype=torch.float32,
                    dtype_per_modal=None):
        return {m: tower_class(m, cfg.encoder_spec(m))(
            cfg.encoder_spec(m), cfg, params=params_from_jax(
                _np_tower(m, cfg.encoder_spec(m)), device,
                (dtype_per_modal or {}).get(m, dtype)))
            for m in cfg.modalities()}

    def port_projector(spec, generator, d_in, d_out, dtype=torch.float32,
                       device=None):
        return params_from_jax(_np_projector(spec, d_in, d_out), device,
                               dtype)

    def jax_params(cfg, rng, quantize_base=False):
        return jax.tree.map(jnp.asarray, _np_backbone(cfg.to_dict()))

    def jax_towers(cfg, rng=None, dtype=None, dtype_per_modal=None):
        out = {}
        for m in cfg.modalities():
            dt = (dtype_per_modal or {}).get(m, dtype) or jnp.float32
            spec = cfg.encoder_spec(m)
            out[m] = jtowers.ClipVisionTower(spec, cfg, params=jax.tree.map(
                lambda a: jnp.asarray(a, dt), _np_tower(m, spec)))
        return out

    def jax_projector(spec, rng, d_in, d_out, dtype=jnp.float32):
        return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                            _np_projector(spec, d_in, d_out))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: one)
        for module in (entry, jentry):
            mp.setattr(module, "TrainConfig", functools.partial(
                module.TrainConfig, adam_eps=ADAM_EPS))
        mp.setattr(entry, "init_params", port_params)
        mp.setattr(entry, "build_modal_encoders", port_towers)
        mp.setattr(entry, "init_projector", port_projector)
        mp.setattr(jllama, "init_params", jax_params)
        mp.setattr(jtowers, "build_modal_encoders", jax_towers)
        mp.setattr(jprojectors, "init_projector", jax_projector)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield


STAGE2 = dict(lora_strategy="modal+language", lora_r=4, lora_alpha=8,
              local_prefix_tokens=1, local_suffix_tokens=1)


def _argv(files, out, **over):
    flags = dict(model_name_or_path=files["base"], version="v1",
                 data_path=files["data"], output_dir=str(out),
                 mm_vision_encoder="test:32x2",
                 mm_projector_type="mlp2x_gelu", mm_vision_select_layer=-2,
                 per_device_train_batch_size=2, max_steps=3,
                 learning_rate=1e-3, bf16="False", tower_dtype="float32",
                 save_steps=2, logging_steps=1, dataloader_num_workers=2)
    flags.update(over)
    return [a for k, v in flags.items() if v is not None
            for a in (f"--{k}", str(v))] + ["--random_init_backbone"]


def _port_train(files, out, time_skip=0, **over):
    args = entry.build_arg_parser().parse_args(_argv(files, out, **over))
    return entry.train(args, tokenizer=FakeLlamaTokenizer(), device="cpu",
                       time_skip=time_skip)


def _jax_train(files, out, **over):
    args = jentry.build_arg_parser().parse_args(_argv(files, out, **over))
    return jentry.train(args, tokenizer=FakeLlamaTokenizer())


def _run_both(files, name, time_skip=0, **over):
    """Both entries on the same flags; ``time_skip`` is the port's keyword
    and the JAX entry's ``MC_LOOP_TIME_SKIP``."""
    root = files["root"]
    with shared_weights(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_LOOP_TIME_SKIP", str(time_skip))
        port = _port_train(files, root / f"port-{name}", time_skip=time_skip,
                           **over)
        jres = _jax_train(files, root / f"jax-{name}", **over)
    return {"port": port, "jax": jres, "port_dir": root / f"port-{name}",
            "jax_dir": root / f"jax-{name}"}


@pytest.fixture(scope="module")
def stage2(files):
    return _run_both(files, "stage2", time_skip=1,
                     group_by_modality_length="True", **STAGE2)


@pytest.fixture(scope="module")
def stage1(files):
    return _run_both(files, "stage1", version="plain",
                     tune_mm_mlp_adapter="True")


def _assert_losses_match(run):
    port, jres = run["port"], run["jax"]
    assert (port["steps"], port["optimizer_steps"]) == \
        (jres["steps"], jres["optimizer_steps"])
    assert len(port["losses"]) == len(jres["losses"]) == port["steps"]
    for got, want in zip(port["losses"], jres["losses"]):
        assert abs(got - want) <= TOL * abs(want), (port["losses"],
                                                    jres["losses"])


def _assert_exports_match(run, stem):
    got = load_state(str(run["port_dir"] / f"{stem}.bin"))
    want = jload_state(str(run["jax_dir"] / f"{stem}.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_max(got[k], want[k]) <= TOL, k
    return got


# ---------------------------------------------------------------------------
# Stage 2 and stage 1 against JAX train()
# ---------------------------------------------------------------------------

def test_stage2_losses_match_jax(stage2):
    _assert_losses_match(stage2)
    assert stage2["port"]["steps"] == 3
    assert np.isfinite(stage2["port"]["losses"]).all()


def test_stage2_steady_window_matches_jax(stage2, stage1):
    """``time_skip=1`` (the JAX ``MC_LOOP_TIME_SKIP``) opens the steady
    window after the first micro-batch: the same steps and bucket positions
    as the JAX entry's, within the loop's time.  Without it (stage 1) no
    window is reported, as in JAX."""
    port, jres = stage2["port"], stage2["jax"]
    assert port["steady_steps"] == jres["steady_steps"] == port["steps"] - 1
    assert port["steady_bucket_tokens"] == jres["steady_bucket_tokens"]
    assert port["steady_bucket_tokens"] % 2 == 0  # B=2 rows a bucket
    assert 0 < port["steady_seconds"] <= port["train_loop_seconds"]
    keys = {"steady_seconds", "steady_steps", "steady_bucket_tokens"}
    assert not keys & (set(stage1["port"]) | set(stage1["jax"]))


def test_stage2_export_matches_jax(stage2):
    got = _assert_exports_match(stage2, "adapter_model")
    assert any(".lora_A.vision." in k for k in got)
    assert "prefix_tokens.vision" in got
    assert any(k.startswith("model.modal_projectors.vision") for k in got)
    # the same config.json, in both packages' readers
    with open(stage2["port_dir"] / "config.json") as f:
        port_cfg = json.load(f)
    with open(stage2["jax_dir"] / "config.json") as f:
        assert port_cfg == json.load(f)


def test_stage2_step_checkpoint_holds_the_trainable_state(stage2):
    """The port's checkpoint-2 holds the trainable leaves only (the
    documented deviation: the JAX one holds the whole tree), each within
    the tolerance of the JAX checkpoint's, with its Adam moments and
    labels."""
    ckpt = stage2["port_dir"] / "checkpoint-2"
    assert tckpt.latest_checkpoint(str(stage2["port_dir"])) == str(ckpt)
    saved = torch.load(ckpt / tckpt.PARAMS_FILE, weights_only=True)
    opt = torch.load(ckpt / tckpt.OPT_FILE, weights_only=True)
    with open(ckpt / tckpt.STATE_FILE) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["count"] == 2
    assert set(saved) == set(meta["labels"]) == set(opt["mu"]) \
        == set(opt["nu"])
    assert set(meta["labels"].values()) == {"lora", "soft", "proj"}
    assert all(k.split("/")[-1] in ("lora_a", "lora_b") or k.startswith(
        ("projectors/", "backbone/prefix_tokens/", "backbone/suffix_tokens/"))
        for k in saved)  # nothing frozen
    want = jload_state(str(stage2["jax_dir"] / "checkpoint-2" /
                           "train_params.safetensors"))
    assert len(want) > len(saved)
    for key, t in saved.items():
        jkey = "params" + "".join(
            f"[{p}]" if p.isdigit() else f"['{p}']" for p in key.split("/"))
        assert _rel_max(t.numpy(), want[jkey]) <= TOL, key


def test_stage1_matches_jax(stage1):
    _assert_losses_match(stage1)
    got = _assert_exports_match(stage1, "mm_projector")
    assert all(k.startswith("model.modal_projectors.vision.") for k in got)
    assert not os.path.exists(stage1["port_dir"] / "adapter_model.bin")


# ---------------------------------------------------------------------------
# build_model from an HF base, and stage-1 projectors across packages
# ---------------------------------------------------------------------------

def _build_args(files, parser, pretrain, **over):
    argv = _argv(files, "-", pretrain_mm_mlp_adapter=pretrain, **over)
    return parser.parse_args(argv[:-1])  # no --random_init_backbone


def test_hf_base_build_model_matches_jax(stage1, files):
    """Both ``build_model`` functions load the tiny HF base, each with the
    other package's stage-1 projector export: every backbone leaf equal,
    except LoRA A (a torch generator against JAX keys: held to its kaiming
    bound, with B zero) and the soft tokens (zero in the port, absent from
    the JAX tree); each loaded projector bit-equal to its file."""
    port_file = str(stage1["port_dir"] / "mm_projector.bin")
    jax_file = str(stage1["jax_dir"] / "mm_projector.bin")
    args = _build_args(files, entry.build_arg_parser(), jax_file, **STAGE2)
    cfg = entry.build_model_config(args)
    assert cfg.num_hidden_layers == 2 and cfg.hidden_size == 64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = entry.build_model(args, cfg, "cpu")
        jargs = _build_args(files, jentry.build_arg_parser(), port_file,
                            **STAGE2)
        jmodel = jentry.build_model(jargs, jentry.build_model_config(jargs))
    got = dict(tree_leaves(params_to_numpy(model.params)))
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(jmodel.params)}
    soft = {p for p in got if p[0] in ("prefix_tokens", "suffix_tokens")}
    assert soft == {("prefix_tokens", "vision"), ("suffix_tokens", "vision")}
    assert all(not got[p].any() for p in soft)
    assert set(got) - soft == set(want)
    n_lora_a = 0
    for path, w in want.items():
        if path[-1] == "lora_a":
            bound = w.shape[-2] ** -0.5
            assert np.abs(got[path]).max() <= bound and got[path].std() > 0
            assert np.abs(w).max() <= bound
            n_lora_a += 1
        else:
            np.testing.assert_array_equal(got[path], w, str(path))
    assert n_lora_a == 7
    # the loaded base is the file's, fp16 -> fp32 exactly
    hf = _hf_state()
    base = params_to_hf_llama(model.params, model.cfg)
    assert all(np.array_equal(base[k], hf[k].astype(np.float32)) for k in hf)
    for proj, path in ((params_to_numpy(model.projectors["vision"]),
                        jax_file),
                       (jax.tree.map(np.asarray, jmodel.projectors["vision"]),
                        port_file)):
        state = load_state(path)
        layers = proj["layers"]
        for d, layer in enumerate(layers):
            pre = f"model.modal_projectors.vision.{2 * d}"
            np.testing.assert_array_equal(layer["w"], state[pre + ".weight"].T)
            np.testing.assert_array_equal(layer["b"], state[pre + ".bias"])


def test_hf_base_quantized_matches_jax(files):
    """``--quantize_frozen_base`` on a loaded base: the int8 weights and
    scales of the JAX package's quantizer on the same base."""
    args = _build_args(files, entry.build_arg_parser(), None,
                       quantize_frozen_base="True", **STAGE2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = entry.build_model(args, entry.build_model_config(args),
                                  "cpu")
    from modelcompose_tpu.compose.convert import hf_llama_to_params
    jcfg = jentry.build_model_config(args)
    jcfg.mm_hidden_size = 32
    want = jquantize(hf_llama_to_params(jload_hf(files["base"]), jcfg))
    got = params_to_numpy(model.params)
    for grp, name in (("attn", "q"), ("attn", "o"), ("mlp", "down")):
        for part in ("q", "scale"):
            np.testing.assert_array_equal(
                got["layers"][grp][name]["w"][part],
                np.asarray(want["layers"][grp][name]["w"][part]))
    np.testing.assert_array_equal(got["lm_head"]["q"],
                                  np.asarray(want["lm_head"]["q"]))


def test_stage2_trains_on_the_jax_stage1_projector(stage1, files):
    """Stage 1 in JAX, stage 2 in the port: the projector the port trains
    from is the JAX export's, bit for bit, before the first step."""
    jax_file = str(stage1["jax_dir"] / "mm_projector.bin")
    seen = {}
    build = entry.build_model

    def capture(args, cfg, device=None):
        model = build(args, cfg, device)
        seen["w0"] = model.projectors["vision"]["layers"][0]["w"] \
            .detach().clone()
        return model
    with shared_weights(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, "build_model", capture)
        res = _port_train(files, files["root"] / "port-from-jax-stage1",
                          pretrain_mm_mlp_adapter=jax_file, max_steps=2,
                          **STAGE2)
    np.testing.assert_array_equal(
        seen["w0"].numpy(),
        load_state(jax_file)["model.modal_projectors.vision.0.weight"].T)
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()


# ---------------------------------------------------------------------------
# The memory levers, accumulation and the trained tower against JAX
# ---------------------------------------------------------------------------

LEVERS = {
    # int8 frozen base, chunked CE, and an accumulation window of 2
    "quantized_chunked_accum": dict(quantize_frozen_base="True",
                                    loss_chunk=128,
                                    gradient_accumulation_steps=2,
                                    max_steps=2, save_steps=0),
    # the vision tower trains (CLIP forward inside the step)
    "tower_lr": dict(mm_vision_tower_lr=2e-3,
                     mm_vision_tower_layerwise_lr_decay=0.5),
}


@pytest.mark.parametrize("case", sorted(LEVERS))
def test_entry_levers_match_jax(files, case):
    run = _run_both(files, case, **STAGE2, **LEVERS[case])
    _assert_losses_match(run)
    _assert_exports_match(run, "adapter_model")
    if case == "quantized_chunked_accum":
        assert run["port"]["steps"] == 4 and \
            run["port"]["optimizer_steps"] == 2


# ---------------------------------------------------------------------------
# Resume (the port alone)
# ---------------------------------------------------------------------------

class _Interrupted(Exception):
    pass


def _interrupt_after(step):
    save = entry.save_step_checkpoint

    def save_then_stop(output_dir, s, state, tx):
        path = save(output_dir, s, state, tx)
        if s == step:
            raise _Interrupted(path)
        return path
    return save_then_stop


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_is_bit_equal_to_an_uninterrupted_run(files, accum):
    """Four optimizer steps in one run, against a run cut off right after
    checkpoint-2 and resumed with the same flags: the same losses and the
    same exported tensors, bit for bit.  At accumulation 2 the resumed run
    fast-forwards over two whole epochs of the 5-sample dataset."""
    root = files["root"]
    kw = dict(STAGE2, max_steps=4, save_steps=2,
              gradient_accumulation_steps=accum,
              group_by_modality_length="True")
    full_dir, cut_dir = root / f"full-{accum}", root / f"cut-{accum}"
    with shared_weights():
        full = _port_train(files, full_dir, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(entry, "save_step_checkpoint", _interrupt_after(2))
            with pytest.raises(_Interrupted):
                _port_train(files, cut_dir, **kw)
        assert not os.path.exists(cut_dir / "adapter_model.bin")
        resumed = _port_train(files, cut_dir, **kw)
    assert resumed["resumed_from"] == str(cut_dir / "checkpoint-2")
    assert resumed["start_step"] == 2
    assert (resumed["steps"], resumed["optimizer_steps"]) == (4 * accum, 4)
    assert full["losses"][2 * accum:] == resumed["losses"]
    assert len(resumed["losses"]) == 2 * accum
    got = load_state(str(cut_dir / "adapter_model.bin"))
    want = load_state(str(full_dir / "adapter_model.bin"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    # checkpoint-4 of both runs: the same trainable state and moments
    for name in (tckpt.PARAMS_FILE, tckpt.OPT_FILE):
        a = torch.load(cut_dir / "checkpoint-4" / name, weights_only=True)
        b = torch.load(full_dir / "checkpoint-4" / name, weights_only=True)
        flat_a = dict(tree_leaves(a))
        flat_b = dict(tree_leaves(b))
        assert sorted(flat_a) == sorted(flat_b)
        assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)


RESUME_MISMATCH = {
    # stage 1 trains the projectors only: the LoRA and soft-token keys
    "trainable_set": (dict(tune_mm_mlp_adapter="True"), "not trained in"),
    # a wider adapter: every LoRA leaf has another shape
    "shape": (dict(lora_r=8), "this run ((2, 2, 64, 8)"),
    # weight decay splits the norm/bias leaves into ':nodecay' labels
    "label": (dict(weight_decay=0.1), "label 'proj', this run "
                                      "'proj:nodecay'"),
}


@pytest.mark.parametrize("case", sorted(RESUME_MISMATCH))
def test_resume_refuses_another_trainable_state(files, case):
    over, message = RESUME_MISMATCH[case]
    out = files["root"] / f"mismatch-{case}"
    kw = dict(STAGE2, max_steps=3, save_steps=1)
    with shared_weights():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(entry, "save_step_checkpoint", _interrupt_after(1))
            with pytest.raises(_Interrupted):
                _port_train(files, out, **kw)
        with pytest.raises(ValueError, match="does not match") as err:
            _port_train(files, out, **dict(kw, **over))
    assert message in str(err.value)


# ---------------------------------------------------------------------------
# Full finetune, the CLI
# ---------------------------------------------------------------------------

def test_full_finetune_exports_an_hf_base_both_packages_load(files):
    """lora_strategy absent: every backbone leaf trains and the export is
    the whole base as ``pytorch_model.bin`` (no ``.safetensors`` beside it,
    which would shadow it), read the same by both packages' HF loaders and
    equal to the trained backbone; the step checkpoint holds every backbone
    leaf."""
    out = files["root"] / "full-finetune"
    seen = {}
    build = entry.build_model

    def capture(args, cfg, device=None):
        seen["model"] = build(args, cfg, device)
        return seen["model"]
    with shared_weights(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, "build_model", capture)
        res = _port_train(files, out, max_steps=2, save_steps=2)
    assert res["steps"] == 2
    assert not list(out.glob("*.safetensors"))
    got, want = load_hf_llama_dir(str(out)), jload_hf(str(out))
    trained = params_to_hf_llama(seen["model"].params, seen["model"].cfg)
    assert sorted(got) == sorted(want) == sorted(trained)
    for k in trained:
        np.testing.assert_array_equal(got[k], want[k], k)
        np.testing.assert_array_equal(got[k], trained[k], k)
    assert not np.array_equal(trained["model.layers.0.mlp.up_proj.weight"],
                              _np_backbone(seen["model"].cfg.to_dict())
                              ["layers"]["mlp"]["up"]["w"][0].T)
    saved = torch.load(out / "checkpoint-2" / tckpt.PARAMS_FILE,
                       weights_only=True)
    assert {k for k in saved if k.startswith("backbone/")} == {
        "backbone/" + "/".join(map(str, p)) for p, _ in
        tree_leaves(seen["model"].params)}


def test_cli_help():
    proc = subprocess.run(
        [sys.executable, "-m", "modelcompose_tpu_torch.train.train_multimodal",
         "--help"], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert "--pretrain_mm_mlp_adapter" in proc.stdout


# ---------------------------------------------------------------------------
# The point recipe end to end from the HF base (the port alone)
# ---------------------------------------------------------------------------

def test_point_stage1_stage2_export_serves(files, tmp_path):
    """The smoke's ``train_entry`` flow at the tiny size, with the real
    builders: stage 1 (plain captions, projector only) and stage 2 (v1
    conversations, modal+language LoRA, 1+1 soft tokens) on a point tower
    from the HF base on disk, then the export loaded by
    ``load_pretrained_model`` (every trained leaf bit-equal) answering a
    point question through ``run_questions``."""
    from modelcompose_tpu_torch.eval import model_multimodal_qa_loader as qa
    rng = np.random.default_rng(0)
    samples = []
    for i in range(6):
        npy = str(tmp_path / f"cloud{i}.npy")
        np.save(npy, rng.normal(size=(64, 6)).astype(np.float32))
        samples.append(npy)
    plain = [{"id": i, "conversations": [
        {"from": "human", "value": "<point>\n"},
        {"from": "gpt", "value": f"a small object number {i}"}],
        "modal_inputs": {"point": [p]}} for i, p in enumerate(samples)]
    v1 = [{"id": i, "conversations": [
        {"from": "human", "value": "<point>\nWhat is this object?"},
        {"from": "gpt", "value": f"It is object {i}."}],
        "modal_inputs": {"point": [p]}} for i, p in enumerate(samples)]
    for name, data in (("plain", plain), ("v1", v1)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(data, f)
    common = dict(mm_vision_encoder=None, mm_point_encoder="test:16x2",
                  mm_point_projector_type="mlp2x_gelu",
                  gradient_checkpointing="True", bf16="False")
    seen = {}
    build = entry.build_model

    def capture(args, cfg, device=None):
        model = build(args, cfg, device)
        seen["model"] = model
        seen["before"] = {p: t.detach().clone() for p, t in tree_leaves(
            {"backbone": model.params, "projectors": model.projectors,
             "tower": model.encoders["point"].params})}
        return model

    def run(out, **over):
        argv = _argv(files, out, **dict(common, **over))[:-1]
        args = entry.build_arg_parser().parse_args(argv)
        with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mp.setattr(entry, "build_model", capture)
            res = entry.train(args, tokenizer=FakeLlamaTokenizer(),
                              device="cpu")
        model = seen["model"]
        after = dict(tree_leaves({"backbone": model.params,
                                  "projectors": model.projectors,
                                  "tower": model.encoders["point"].params}))
        changed = {p for p, t in after.items()
                   if not torch.equal(t.detach(), seen["before"][p])}
        return res, model, changed

    s1_dir = tmp_path / "point-stage1"
    res1, _, changed1 = run(s1_dir, version="plain",
                            data_path=str(tmp_path / "plain.json"),
                            tune_mm_mlp_adapter="True",
                            per_device_train_batch_size=3, max_steps=2)
    assert np.isfinite(res1["losses"]).all() and res1["steps"] == 2
    assert changed1 and all(p[0] == "projectors" for p in changed1)
    s2_dir = tmp_path / "point-multimodal"
    proj_file = str(s1_dir / "mm_projector.bin")
    res2, model, changed2 = run(
        s2_dir, data_path=str(tmp_path / "v1.json"),
        pretrain_mm_mlp_adapter=proj_file, max_steps=3, **STAGE2)
    np.testing.assert_array_equal(
        seen["before"][("projectors", "point", "layers", 0, "w")].numpy(),
        load_state(proj_file)["model.modal_projectors.point.0.weight"].T)
    assert np.isfinite(res2["losses"]).all() and res2["steps"] == 3
    frozen = {p for p in changed2 if p[0] == "tower" or (
        p[0] == "backbone" and p[-1] not in ("lora_a", "lora_b")
        and p[1] not in ("prefix_tokens", "suffix_tokens"))}
    assert not frozen, frozen
    assert {p[-1] for p in changed2 if p[0] == "backbone"
            and p[1] == "layers"} == {"lora_a", "lora_b"}
    lora_b = model.params["layers"]["attn"]["q"]["lora_b"].detach()
    assert all(lora_b[:, a].abs().sum() > 0 for a in range(2))
    assert ("backbone", "prefix_tokens", "point") in changed2
    assert any(p[0] == "projectors" for p in changed2)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tok, served, procs, _ = load_pretrained_model(
            str(s2_dir), files["base"], device="cpu",
            load_tokenizer_fn=lambda _: FakeLlamaTokenizer())
    trained = {p: t for p, t in tree_leaves(
        {"backbone": model.params, "projectors": model.projectors})
        if t.requires_grad}
    loaded = dict(tree_leaves({"backbone": served.params,
                               "projectors": served.projectors}))
    assert len(trained) == 7 * 2 + 2 + 4
    for p, t in trained.items():
        assert torch.equal(loaded[p], t.detach()), p
    assert not any(t.requires_grad for _, t in tree_leaves(served.params))
    qfile = tmp_path / "q.json"
    with open(qfile, "w") as f:
        json.dump([{"id": 0, "conversations": [
            {"from": "human", "value": "<point>\nWhat is it?"},
            {"from": "gpt", "value": None}],
            "modal_inputs": {"point": [samples[0]]}}], f)
    qargs = qa.parse_args(["--model-path", str(s2_dir), "--model-base",
                           files["base"], "--question-file", str(qfile),
                           "--answers-file", str(tmp_path / "a.jsonl"),
                           "--max-new-tokens", "4", "--protocol",
                           "benchmark"])
    qa.run_questions(qargs, tok, served, procs, "point-multimodal")
    with open(tmp_path / "a.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["question_id"] for line in lines] == [0]
